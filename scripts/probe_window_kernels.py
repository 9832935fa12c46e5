"""What bounds the wg window attention kernels, measured on the card by
timing edited copies of ``csrc/window_attention.cu`` against each other.

    python scripts/probe_window_kernels.py [--variants a,b,...] [--runs 20]
    python scripts/probe_window_kernels.py --labels

Each variant is a list of text edits to the current source: a part of the
kernels removed (their results are then wrong, and only timed), or a
design alternative (held against the plain versions). Each edit's text
must occur exactly once in the source (``_edited``; the CPU test
``tests/test_torch_window_attention_layout.py`` holds every variant to
that, so a stale edit fails there and not on the card). Every variant's
copy of the source and of ``csrc/hopper.cuh`` is built with one ``nvcc``
each, all started together, into ``build/window_probe/<variant>/``; each
library is loaded with ctypes in place of the package's and timed at
swin_fpn_visceral's stage 2 (shifted and unshifted), stage 3 and stage 5
windows at batch 2, the variants in turns (forward order, then reverse),
with the generic kernels of the package beside them. Prints one JSON line
per variant (registers and spills of fwd_wg / bwd_wg, whether it matches
the plain versions) and per shape (median ms of each variant's forward
and backward, twice). Timing and inputs are chip_smoke.py's.

``--labels`` builds nothing and times the public wrappers at the same
shapes, host work included, with the wg kernels' padded labels kept on
the region tensor (as the wrapper does) and made anew on every call, in
turns. Needs one CUDA card; imports no jax.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import _median_ms, _window_inputs  # noqa: E402
from transoar_tpu_torch.ops.kernels import _build  # noqa: E402
from transoar_tpu_torch.ops.kernels import window_attention as wa  # noqa: E402

CSRC = ROOT / "transoar_tpu_torch" / "csrc"
OUT = ROOT / "build" / "window_probe"
# B_, H, nW: stage 2 unshifted and shifted, stage 3 and stage 5 shifted
SHAPES = [(13312, 3, 1), (13312, 3, 6656), (1664, 6, 832), (32, 24, 16)]


def _between(src: str, start: str, end: str) -> str:
    """The text of ``src`` from ``start`` up to (not including) ``end``."""
    i = src.index(start)
    return src[i:src.index(end, i)]


def _variants(src: str) -> dict:
    """name -> [(old, new)] edits of the current source."""
    exps = [(f"ex2(fmaf(sc[4 * j{e}], L2E, n{r}))",
             f"fmaf(sc[4 * j{e}], L2E, n{r})")
            for e, r in (("", "a"), (" + 1", "a"), (" + 2", "b"),
                         (" + 3", "b"))]
    mask = [(f"({lab} != lc.{c} ? MASK : 0.f)", "0.f")
            for lab, c in (("la", "x"), ("la", "y"), ("lb", "x"),
                           ("lb", "y"))]
    stage = _between(src, "        st_u32(w + STAGED, hi[kk][2 * u]);",
                     "      }\n    }\n    hopper::fence_async_smem();")
    dvdk = _between(src, "#pragma unroll\n    for (int kk = 0; kk < 8; ++kk)"
                    "  // dv = P^T do", "    hopper::wgmma_commit();\n"
                    "    hopper::wgmma_wait<0>();\n    hopper::fence_regs(aq)")
    fwd_body = _between(src, "    float sc[64];\n    scores(sc, qs + 64 * g",
                        "    __syncwarp();\n    if (lane == 0) hopper::"
                        "mbar_arrive(&empty[s]);")
    bwd_body = _between(src, "    // S, its softmax, then dP:",
                        "    __syncwarp();\n    if (lane == 0) {  // the last")
    zeros = "{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}"
    fwd_copy = (f"    float acc[8] = {zeros};\n    const float sa = 1.f, "
                f"sb = 1.f;\n    (void)ks;\n    (void)vs;\n")
    bwd_copy = (f"    float aq[8] = {zeros}, av[8] = {zeros}, ak[8] = "
                f"{zeros};\n    (void)ks;\n    (void)vs;\n    (void)dos;\n"
                f"    (void)my_stg;\n")
    # the forward refilled as the backward is: by the last warp to release
    fwd_init = _between(src, "  if (threadIdx.x == 0) {\n    for (int s = 0;"
                        " s < S; ++s) {\n      hopper::mbar_init(&full[s], "
                        "1);\n      hopper::mbar_init(&empty[s],",
                        "  stage_bias_frag(")
    fwd_tail = _between(src, "    __syncwarp();\n    if (lane == 0) hopper::"
                        "mbar_arrive(&empty[s]);", "  }\n}\n\n// Backward,")
    fwd_release = (
        "  uint32_t* released = reinterpret_cast<uint32_t*>(empty);\n"
        "  if (threadIdx.x == 0) {\n    for (int s = 0; s < S; ++s) {\n"
        "      hopper::mbar_init(&full[s], 1);\n      released[s] = 0;\n"
        "    }\n    hopper::mbar_init_fence();\n"
        "    for (int i = 0; i < min(n, S); ++i) load(i);\n  }\n")
    fwd_release_tail = (
        "    __syncwarp();\n    if (lane == 0) {\n"
        "      __threadfence_block();\n      if ((atomicAdd(&released[s], "
        "1u) & 7u) == 7u && i + S < n) load(i + S);\n    }\n"
        "    store16(o, so, acc, b0 + i, h, ra, rb, c0, N, 1.f / sa, "
        "1.f / sb);\n    __syncwarp();\n")
    # the backward refilled as the forward is: by thread 0, a window later
    bwd_release = _between(src, "    if (lane == 0) {  // the last warp",
                           "\n    const int b = b0 + i;")
    bwd_deferred = (
        "    if (lane == 0) {\n      __threadfence_block();\n"
        "      atomicAdd(&released[s], 1u);\n    }\n"
        "    if (threadIdx.x == 0 && i >= 1 && i - 1 + S < n) {\n"
        "      while (atomicAdd(&released[(i - 1) % S], 0u) <\n"
        "             8u * ((i - 1) / S + 1)) {\n      }\n"
        "      load(i - 1 + S);\n    }\n")
    stages = "constexpr int FWD_STAGES = 3, BWD_STAGES = 3;"
    # the outputs as one 16-byte store a lane: the quad sharing a row pair
    # swaps words (lane q % 4 stores row ra's columns 0-7, 8-15, then rb's)
    store_fn = _between(src, "// An m64n16 accumulator (rows ra, rb;",
                        "// Forward. One block")
    store_quad = """__device__ __forceinline__ void store16(__nv_bfloat16* __restrict__ dst,
                                        Str s, const float (&acc)[8], int b,
                                        int h, int ra, int rb, int c0, int N,
                                        float fa = 1.f, float fb = 1.f) {
  const int q = c0 / 2;
  const uint32_t w[4] = {pack_bf16(acc[0] * fa, acc[1] * fa),
                         pack_bf16(acc[4] * fa, acc[5] * fa),
                         pack_bf16(acc[2] * fb, acc[3] * fb),
                         pack_bf16(acc[6] * fb, acc[7] * fb)};
  uint32_t out[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = q ^ r;
    uint32_t send = w[0];
#pragma unroll
    for (int k = 1; k < 4; ++k)
      if (p == k) send = w[k];
    const uint32_t got = r ? __shfl_xor_sync(0xffffffffu, send, r) : send;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (p == k) out[k] = got;
  }
  const int row = q < 2 ? ra : rb;
  if (row < N)
    *reinterpret_cast<uint4*>(dst + b * s.b + h * s.h + row * s.n +
                              8 * (q % 2)) =
        make_uint4(out[0], out[1], out[2], out[3]);
}

"""
    # the outputs' stores kept from the compiler but never taken (n >= 1)
    stores = [(f"    store16({x}", f"    if (n < 0) store16({x}")
              for x in ("o, so", "dq, sdq", "dv, sdv", "dk, sdk")]
    return {
        "base": [],
        "no_exp": exps,
        "no_mask": mask,
        "no_stage_hi_lo": [(stage, "")],
        "no_dv_dk": [(dvdk, "")],
        "copy_only": [(fwd_body, fwd_copy), (bwd_body, bwd_copy)],
        "no_store": stores,
        "store_quad": [(store_fn, store_quad)],
        "copy_only_no_store": [(fwd_body, fwd_copy), (bwd_body, bwd_copy)]
        + stores,
        "fwd_refill_on_release": [(fwd_init, fwd_release),
                                  (fwd_tail, fwd_release_tail)],
        "bwd_deferred_refill": [(bwd_release, bwd_deferred)],
        "stages_2": [(stages, "constexpr int FWD_STAGES = 2, "
                              "BWD_STAGES = 2;")],
    }


def _edited(src: str, name: str, edits) -> str:
    """``src`` with the variant's edits made; each edit's text must occur
    exactly once."""
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the edit's text occurs "
                               f"{src.count(old)} times: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def _build_variant(name: str, edits) -> Path:
    src = _edited((CSRC / "window_attention.cu").read_text(), name, edits)
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "window_attention.cu").write_text(src)
    (d / "hopper.cuh").write_text((CSRC / "hopper.cuh").read_text())
    so = d / "window_attention.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                           str(so), str(d / "window_attention.cu")],
                          capture_output=True, text=True)
    (d / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    return so


def _use(lib) -> None:
    """Point the wrapper at ``lib`` (the package's library if None)."""
    if lib is None:
        fn = functools.cache(lambda sym: getattr(
            _build.load_library("window_attention"), sym))
    else:
        fn = functools.cache(lambda sym: getattr(lib, sym))

    @functools.cache
    def kernel(symbol):
        f = fn(symbol)
        f.argtypes = wa._ARGTYPES[symbol]
        f.restype = ctypes.c_int
        return f

    wa._kernel = kernel
    wa._wg_target.cache_clear()


def _inputs(B, H, nW, seed=0):
    """chip_smoke.py's window inputs, with q in its own [B_, N, H, d]
    memory as the Swin module's scaled q is, and nW random region rows (one
    zero row for nW = 1)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    region = (torch.zeros((1, 125), device="cuda") if nW == 1 else
              torch.randint(0, 4, (nW, 125), generator=gen,
                            device="cuda").float())
    q, *rest = _window_inputs(gen, B, H, 125, 16, region)
    return (q.transpose(1, 2).contiguous().transpose(1, 2), *rest)


def _labels_turns(runs):
    """The public wrappers' times, host included, with the padded labels
    kept on the region tensor and made anew every call, in turns."""
    def fresh(region):
        region.__dict__.pop("_wg_labels", None)

    for B, H, nW in SHAPES:
        q, k, v, bias, region, do = _inputs(B, H, nW)
        rows = {"kept": {"fwd_ms": [], "bwd_ms": []},
                "anew": {"fwd_ms": [], "bwd_ms": []}}
        for mode in ("kept", "anew", "anew", "kept"):
            pre = fresh if mode == "anew" else (lambda r: None)
            rows[mode]["fwd_ms"].append(_median_ms(lambda: (
                pre(region), wa.fused_window_attention(q, k, v, bias,
                                                       region)), runs))
            rows[mode]["bwd_ms"].append(_median_ms(lambda: (
                pre(region), wa.fused_window_attention_bwd(
                    q, k, v, bias, region, do)), runs))
        print(json.dumps({"shape": [B, H, 125, 16], "region_rows": nW,
                          "labels": rows}), flush=True)
        del q, k, v, do
        torch.cuda.empty_cache()


def _matches(args) -> bool:
    o = wa._launch_fwd(*args[:5])
    grads = wa._launch_bwd(*args)
    ref_o = wa.window_attention_reference(*args[:5])
    ref = wa.window_attention_bwd_reference(*args)
    ok = torch.allclose(o.float(), ref_o.float(), rtol=1.6e-2, atol=1e-2)
    for a, b in zip(grads[:3], ref[:3]):
        ok = ok and torch.allclose(a.float(), b.float(), rtol=1.6e-2,
                                   atol=1e-2)
    rel = ((grads[3] - ref[3]).norm() / ref[3].norm()).item()
    return bool(ok and rel < 1e-4)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variants", default=None,
                        help="comma-separated names (default: all)")
    parser.add_argument("--runs", type=int, default=20)
    parser.add_argument("--labels", action="store_true",
                        help="time the wrappers with the padded labels "
                             "kept and made anew, and nothing else")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    if args.labels:
        _labels_turns(args.runs)
        return
    src = (CSRC / "window_attention.cu").read_text()
    variants = _variants(src)
    names = args.variants.split(",") if args.variants else list(variants)
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(
            lambda n: _build_variant(n, variants[n]), names)))
    libs = {n: ctypes.CDLL(str(so)) for n, so in built.items()}
    check = _inputs(8, 3, 4)
    for name, lib in libs.items():
        _use(lib)
        print(json.dumps({"variant": name, "edits": len(variants[name]),
                          "fwd_wg": wa.kernel_attrs("fwd_wg"),
                          "bwd_wg": wa.kernel_attrs("bwd_wg"),
                          "matches_plain": _matches(check)}), flush=True)
    order = names + names[::-1]
    for B, H, nW in SHAPES:
        inputs = _inputs(B, H, nW)
        rows = {n: {"fwd_ms": [], "bwd_ms": []} for n in names}
        for name in order:
            _use(libs[name])
            rows[name]["fwd_ms"].append(_median_ms(
                lambda: wa._launch_fwd(*inputs[:5]), args.runs))
            rows[name]["bwd_ms"].append(_median_ms(
                lambda: wa._launch_bwd(*inputs), args.runs))
        _use(None)
        generic = {"fwd_ms": _median_ms(lambda: wa._launch_fwd(
            *inputs[:5], "generic"), args.runs),
            "bwd_ms": _median_ms(lambda: wa._launch_bwd(
                *inputs, "generic"), args.runs)}
        print(json.dumps({"shape": [B, H, 125, 16], "region_rows": nW,
                          "variants": rows, "generic": generic}),
              flush=True)
        del inputs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
