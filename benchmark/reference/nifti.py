"""Plain NIfTI-1 reading, writing and RAS reorientation.

A frozen copy of ``transoar_tpu_torch/data/nifti.py`` at commit bf64563
(``load_nifti``, ``reorient_ras``, ``write_nifti``), with the writer's gzip
level as an argument: the benchmark writes its request volumes at level 1.
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _open(path):
    path = str(path)
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def load_nifti(path):
    """Read a .nii / .nii.gz file.

    Returns dict with 'data' [X, Y, Z(, T)] float32, 'affine' [4, 4],
    'spacing' [3], 'qform_code' and 'sform_code'.
    """
    with _open(path) as f:
        header = f.read(348)
        if len(header) < 348:
            raise ValueError(f"truncated NIfTI header: {path}")
        sizeof_hdr = struct.unpack("<i", header[:4])[0]
        if sizeof_hdr != 348:
            raise ValueError(f"not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")

        dim = struct.unpack("<8h", header[40:56])
        datatype = struct.unpack("<h", header[70:72])[0]
        pixdim = struct.unpack("<8f", header[76:108])
        vox_offset = struct.unpack("<f", header[108:112])[0]
        scl_slope = struct.unpack("<f", header[112:116])[0]
        scl_inter = struct.unpack("<f", header[116:120])[0]
        sform_code = struct.unpack("<h", header[254:256])[0]
        qform_code = struct.unpack("<h", header[252:254])[0]
        srow = np.array(struct.unpack("<12f", header[280:328])).reshape(3, 4)

        if datatype not in _DTYPES:
            raise ValueError(f"unsupported NIfTI datatype {datatype}")
        dtype = np.dtype(_DTYPES[datatype]).newbyteorder("<")

        ndim = dim[0]
        shape = tuple(dim[1:1 + max(ndim, 3)])
        count = int(np.prod(shape))

        f.seek(int(vox_offset))
        data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype)
        data = data.reshape(shape, order="F").astype(np.float32)

    # slope * v + inter whenever the slope is set and not the identity
    if (scl_slope != 0.0 and np.isfinite(scl_slope)
            and np.isfinite(scl_inter)
            and (scl_slope, scl_inter) != (1.0, 0.0)):
        data = data * scl_slope + scl_inter

    if sform_code > 0:
        affine = np.vstack([srow, [0, 0, 0, 1]])
    else:
        # qform only: spacing from pixdim, the quaternion rotation ignored
        affine = np.diag([pixdim[1], pixdim[2], pixdim[3], 1.0])
    spacing = np.abs(np.array([pixdim[1], pixdim[2], pixdim[3]], np.float32))

    return {
        "data": data,
        "affine": affine.astype(np.float64),
        "spacing": spacing,
        "qform_code": qform_code,
        "sform_code": sform_code,
    }


def write_nifti(data, path, affine=None, spacing=(1.0, 1.0, 1.0),
                level=9):
    """Write a float32/int NIfTI-1 single file (.nii or .nii.gz)."""
    data = np.asarray(data)
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)
    code = _DTYPE_CODES[np.dtype(data.dtype)]
    if affine is None:
        affine = np.diag([*spacing, 1.0])

    header = bytearray(352)
    struct.pack_into("<i", header, 0, 348)
    dims = [data.ndim, *data.shape] + [1] * (7 - data.ndim)
    struct.pack_into("<8h", header, 40, *dims)
    struct.pack_into("<h", header, 70, code)
    struct.pack_into("<h", header, 72, data.dtype.itemsize * 8)
    struct.pack_into("<8f", header, 76, 1.0, *spacing,
                     *([1.0] * (7 - 3)))
    struct.pack_into("<f", header, 108, 352.0)  # vox_offset
    struct.pack_into("<f", header, 112, 1.0)  # scl_slope
    struct.pack_into("<h", header, 254, 1)  # sform_code
    struct.pack_into("<12f", header, 280, *affine[:3].ravel())
    header[344:348] = b"n+1\0"

    payload = bytes(header) + data.astype(data.dtype).tobytes(order="F")
    path = str(path)
    if path.endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=level) as f:
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)


def reorient_ras(data, affine):
    """Reorient a volume so voxel axes align with +R +A +S world axes.

    Returns (data_ras, affine_ras).
    """
    rot = affine[:3, :3]
    # voxel axis j maps mostly to world axis argmax(|rot[:, j]|)
    perm = np.argmax(np.abs(rot), axis=0)
    if len(set(perm.tolist())) != 3:
        perm = np.array([0, 1, 2])
    inv = np.argsort(perm)
    data = np.transpose(data, axes=inv[:data.ndim] if data.ndim == 3
                        else list(inv) + list(range(3, data.ndim)))
    rot = rot[:, inv]
    offset = affine[:3, 3].copy()

    flips = []
    for world_axis in range(3):
        if rot[world_axis, world_axis] < 0:
            flips.append(world_axis)
    if flips:
        data = np.flip(data, axis=tuple(flips))
    new_affine = np.eye(4)
    for a in range(3):
        scale = abs(rot[a, a])
        new_affine[a, a] = scale
    new_affine[:3, 3] = offset
    return np.ascontiguousarray(data), new_affine
