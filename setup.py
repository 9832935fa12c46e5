"""Package setup (reference setup.py:20-31 equivalent)."""

from setuptools import find_packages, setup

setup(
    name="transoar_tpu",
    version="0.1.0",
    description=("TPU-native framework for Transformer-based 3D "
                 "organs-at-risk detection in CT volumes (JAX/XLA/Pallas)"),
    packages=find_packages(include=["transoar_tpu", "transoar_tpu.*",
                                    "transoar_tpu_torch",
                                    "transoar_tpu_torch.*"]),
    package_data={"transoar_tpu.native": ["*.cpp"],
                  "transoar_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=[
        "jax", "flax", "optax", "orbax-checkpoint", "numpy", "scipy",
        "pyyaml",
    ],
    extras_require={
        "viz": ["pillow"],
        "logging": ["tensorboardX"],
        "test": ["pytest", "torch"],
    },
)
