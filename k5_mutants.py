"""Shows that ``chip_smoke.py``'s bars for K5 reject a wrong kernel: the bf16
forward, and the f32 forward and backward (dkv, dq; 3xTF32 on the tensor
cores).

Run from the repository root on a machine with an NVIDIA H100 and ``nvcc``:
``python3 k5_mutants.py``. It builds mutants from patched copies of
``kernels/flash_attention.cu`` (``flash_bf16_kernel``, ``flash_f32_kernel``),
``kernels/flash_attention_bwd.cu`` (the f32 kernels) and the headers they
share (``flash_common.cuh``) in a temporary directory (the repository's
sources stay as they are), all at once, and launches each through the
port's wrappers. The bf16 forward runs at the kernel table's shape (1, 16,
8192; one 6,500-token chunk) and at packed rows (4, 16, 2048; 100-token
segments): for the shipped kernel and each mutant, the max |diff| against
the plain version and the largest row-relative diff, each beside its bar
(``K5_ATOL``, ``K5_FWD_REL_BF16``). The f32 forward and backward run at the
table shape and on the "no key in a skipped tile" layout of
``_skip_layouts`` (1, 16, 2048): the max |diff| of the output (forward,
beside ``K5_ATOL["float32"]``) or of dq, dk and dv (backward, beside
``K5_BWD_ATOL_F32``) against the plain version. One JSON object a line.
Exits 1 if a shipped kernel fails a bar, a bf16 forward mutant passes the
row-relative one, or an f32 mutant passes the f32 bar on both inputs.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke as cs
from intool_rag_tpu_torch.kernels import build
from intool_rag_tpu_torch.ops import flash_attention as fa

_LIN2 = "__device__ __forceinline__ float lin2(float x) { return fmaxf(1.f + 0.6931472f * x, 0.f); }\n"
_SOFTMAX = "template <bool UNIFORM, int NV>\n__device__ __forceinline__ void softmax_tile"
# name -> (text in flash_attention.cu, its replacement), each text present in the source
FWD_MUTANTS = {
    "no p.v": [
        ("mma_ra<64>(o, pa + 4 * kk, vb + 128 * kk, 1);", ";"),
        ("mma_ra<64>(o_acc, pa + 4 * kk, vb + 128 * kk, 1);", ";"),
    ],
    "p from 1 + x ln 2, not 2^x": [
        ("s[v] = ex2(", "s[v] = lin2("),
        ("s[v + 1] = ex2(", "s[v + 1] = lin2("),
        (_SOFTMAX, _LIN2 + _SOFTMAX),
    ],
    "output 20 % low": [
        ("const float inv[2] = {1.f / l[0], 1.f / l[1]};", "const float inv[2] = {0.8f / l[0], 0.8f / l[1]};"),
    ],
    "o not rescaled by alpha": [
        ("for (int v = 0; v < 32; ++v) o[v] *= alpha[(v >> 1) & 1];", ";"),
    ],
}


# the f32 backward (flash_attention_bwd.cu): each product one tf32 product, the
# transposed planes unpermuted under the register-A fragment, rows no key matches
# not keeping their tiles
BWD_MUTANTS = {
    "f32 backward: one tf32 product per pair (lo terms dropped)": [
        ("    mma<float, F_T>(acc, ah, bl, 1);\n    mma<float, F_T>(acc, al, bh, 1);\n", ""),
        ("    mma_ra_tf32<64>(acc, x_hi + 4 * c, b_lo + 2 * c, 1);\n"
         "    mma_ra_tf32<64>(acc, x_lo + 4 * c, b_hi + 2 * c, 1);\n", ""),
    ],
    "f32 backward: register A without the row permutation": [
        ("return f < 4 ? 2 * f : 2 * f - 7;", "return f;"),
    ],
    "f32 backward: skip ignores rows no key matches": [
        ("const bool nm = own_nm || pl.nomatch[t];", "const bool nm = false;"),
    ],
}


# the f32 forward (flash_attention.cu; its products and the split live in
# flash_common.cuh, shared with the f32 backward): each product one tf32
# product, the vT planes unpermuted under p's register-A fragment, no second
# walk for rows no key matches
F32_FWD_MUTANTS = {
    "f32 forward: one tf32 product per pair (lo terms dropped)": [
        ("    mma_ra_tf32<F_T>(acc, a_hi + 4 * kk, bl, 1);\n    mma_ra_tf32<F_T>(acc, a_lo + 4 * kk, bh, 1);\n", ""),
        ("    mma_ra_tf32<64>(acc, x_hi + 4 * c, b_lo + 2 * c, 1);\n"
         "    mma_ra_tf32<64>(acc, x_lo + 4 * c, b_hi + 2 * c, 1);\n", ""),
    ],
    "f32 forward: register A without the row permutation": [
        ("return f < 4 ? 2 * f : 2 * f - 7;", "return f;"),
    ],
    "f32 forward: skip ignores rows no key matches": [
        ("if (!__syncthreads_or(m2[0] <= MASK_VALUE || m2[1] <= MASK_VALUE)) break;",
         "if (!__syncthreads_or(0)) break;"),
    ],
}


def _build_mutant(work: Path, source: str, name: str, edits) -> ctypes.CDLL:
    """Patches copies of ``source`` and the headers in the new directory
    ``work`` (each edit where its text is found: the source, else a header)
    and builds it with the port's nvcc flags; returns the loaded library,
    its argument types set."""
    files = {source: (build.KERNEL_DIR / source).read_text()}
    files.update({h.name: h.read_text() for h in sorted(build.KERNEL_DIR.glob("*.cuh"))})
    for old, new in edits:
        where = next((f for f, text in files.items() if old in text), None)
        if where is None:
            raise ValueError(f"mutant {name!r}: {old!r} is not in {source} or its headers")
        files[where] = files[where].replace(old, new)
    work.mkdir()
    for f, text in files.items():
        (work / f).write_text(text)
    lib_path = work / "lib.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path), str(work / source)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"mutant {name!r} did not build:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    if source == "flash_attention_bwd.cu":
        return fa.bind_bwd(lib)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_segments.argtypes = [p] * 8 + [i] * 4 + [ll] * 12 + [ctypes.c_float, p, p]
    lib.flash_attention_segments.restype = ctypes.c_int
    return lib


def _no_key_layout(dev):
    return [torch.as_tensor(x, device=dev) for x in cs._skip_layouts(1, 2048)["no key in a skipped tile"]]


def _forward_f32(dev, gen, libs: dict) -> list[str]:
    """The f32 forward, shipped and mutants, against the plain forward;
    returns what the bar misjudged."""
    seg = (torch.arange(8192, device=dev)[None] < 6500).to(torch.int32)
    inputs = {"(1, 16, 8192), one 6,500-token chunk": (seg, seg),
              "(1, 16, 2048), no key in a skipped tile": tuple(_no_key_layout(dev))}
    lib_of_module, failed, wrong = fa._lib, {name: False for name in libs}, []
    try:
        for shape, (seg_q, seg_kv) in inputs.items():
            q, k, v = (x.contiguous() for x in cs._k5_inputs(seg_q, 16, torch.float32, gen))
            want = fa.flash_attention_plain(q, k, v, seg_q, seg_kv, 0.125)
            for name, lib in {"shipped": lib_of_module(), **libs}.items():
                fa._lib = lambda lib=lib: lib
                got = fa.flash_attention_segments(q, k, v, seg_q, seg_kv, 0.125)
                err = (got - want).abs().max().item()
                passes = err <= cs.K5_ATOL["float32"] and bool(torch.isfinite(got).all())
                print(json.dumps({"shape": shape, "kernel": name, "max_abs": err, "atol": cs.K5_ATOL["float32"]}),
                      flush=True)
                if name == "shipped" and not passes:
                    wrong.append(f"{shape} | shipped f32 forward")
                elif name != "shipped":
                    failed[name] |= not passes
                del got
            del q, k, v, want
            torch.cuda.empty_cache()
    finally:
        fa._lib = lib_of_module
    return wrong + [f"{name} passed on every input" for name, f in failed.items() if not f]


def _backward(dev, gen, libs: dict) -> list[str]:
    """The f32 backward, shipped and mutants, against the plain backward;
    returns what the bar misjudged."""
    seg = (torch.arange(8192, device=dev)[None] < 6500).to(torch.int32)
    inputs = {"(1, 16, 8192), one 6,500-token chunk": (seg, seg),
              "(1, 16, 2048), no key in a skipped tile": tuple(_no_key_layout(dev))}
    lib_of_module, failed, wrong = fa._lib_bwd, {name: False for name in libs}, []
    try:
        for shape, (seg_q, seg_kv) in inputs.items():
            q, k, v = (x.contiguous() for x in cs._k5_inputs(seg_q, 16, torch.float32, gen))
            do = cs._k5_inputs(seg_q, 16, torch.float32, gen)[0].contiguous()
            out, l, m = fa._forward_cuda(q, k, v, seg_q, seg_kv, 0.125, True)
            want = fa.flash_attention_backward_plain(q, k, v, seg_q, seg_kv, out, l, m, do, 0.125)
            for name, lib in {"shipped": lib_of_module(), **libs}.items():
                fa._lib_bwd = lambda lib=lib: lib
                got = fa.flash_attention_backward(q, k, v, seg_q, seg_kv, out, l, m, do, 0.125)
                errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
                passes = max(errs) <= cs.K5_BWD_ATOL_F32 and all(torch.isfinite(g).all() for g in got)
                print(json.dumps({"shape": shape, "kernel": name, "max_abs dq dk dv": errs,
                                  "atol": cs.K5_BWD_ATOL_F32}), flush=True)
                if name == "shipped" and not passes:
                    wrong.append(f"{shape} | shipped f32 backward")
                elif name != "shipped":
                    failed[name] |= not passes
                del got
            del q, k, v, do, out, l, m, want
            torch.cuda.empty_cache()
    finally:
        fa._lib_bwd = lib_of_module
    return wrong + [f"{name} passed on every input" for name, f in failed.items() if not f]


def main() -> int:
    if not torch.cuda.is_available():
        print("k5_mutants.py needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    mutants = [("flash_attention.cu", name, edits) for name, edits in FWD_MUTANTS.items()]
    mutants += [("flash_attention.cu", name, edits) for name, edits in F32_FWD_MUTANTS.items()]
    mutants += [("flash_attention_bwd.cu", name, edits) for name, edits in BWD_MUTANTS.items()]
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(mutants)) as pool:  # one nvcc a mutant, all at once
            built = dict(zip((name for _, name, _ in mutants),
                             pool.map(lambda i_m: _build_mutant(Path(tmp) / str(i_m[0]), *i_m[1]),
                                      enumerate(mutants))))
        libs = {name: built[name] for name in FWD_MUTANTS}
        f32_fwd_libs = {name: built[name] for name in F32_FWD_MUTANTS}
        bwd_libs = {name: built[name] for name in BWD_MUTANTS}
        lib_of_module, shipped = fa._lib, fa._lib()
        gen = torch.Generator(device=dev).manual_seed(11)
        shapes = {
            "(1, 16, 8192), one 6,500-token chunk": (torch.arange(8192, device=dev)[None] < 6500).to(torch.int32),
            "(4, 16, 2048), 100-token segments": (torch.arange(2048, device=dev) // 100 + 1).to(torch.int32).repeat(4, 1),
        }
        wrong = []
        try:
            for shape, seg in shapes.items():
                q, k, v = (x.contiguous() for x in cs._k5_inputs(seg, 16, torch.bfloat16, gen))
                want = fa.flash_attention_plain(q, k, v, seg, seg, 0.125)
                for name, lib in {"shipped": shipped, **libs}.items():
                    fa._lib = lambda lib=lib: lib
                    got = fa.flash_attention_segments(q, k, v, seg, seg, 0.125)
                    err = (got.float() - want.float()).abs().max().item()
                    rel = cs._row_rel_err(got, want)
                    print(json.dumps({"shape": shape, "kernel": name, "max_abs": err, "atol": cs.K5_ATOL["bfloat16"],
                                      "row_rel": rel, "row_rel_bar": cs.K5_FWD_REL_BF16}), flush=True)
                    # the shipped kernel passes both bars; every mutant fails the row-relative one
                    if name == "shipped":
                        right = err <= cs.K5_ATOL["bfloat16"] and rel <= cs.K5_FWD_REL_BF16
                    else:
                        right = rel > cs.K5_FWD_REL_BF16
                    if not right:
                        wrong.append(f"{shape} | {name}")
                del want
        finally:
            fa._lib = lib_of_module
        torch.cuda.empty_cache()
        wrong += _forward_f32(dev, gen, f32_fwd_libs)
        wrong += _backward(dev, gen, bwd_libs)
    if wrong:
        print(f"bars misjudged: {wrong}", file=sys.stderr)
        return 1
    print("every bf16 forward mutant fails the row-relative bar and every f32 forward and backward mutant the "
          "f32 bar; the shipped kernels pass")
    return 0


if __name__ == "__main__":
    sys.exit(main())
