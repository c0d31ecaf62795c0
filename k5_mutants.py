"""Shows that ``chip_smoke.py``'s bars for K5's bf16 forward reject a wrong kernel.

Run from the repository root on a machine with an NVIDIA H100 and ``nvcc``:
``python3 k5_mutants.py``. It builds mutants of ``flash_bf16_kernel`` from
patched copies of ``kernels/flash_attention.cu`` in a temporary directory
(the repository's sources stay as they are), launches each through the
port's wrapper at the kernel table's shape (1, 16, 8192; one 6,500-token
chunk) and at packed rows (4, 16, 2048; 100-token segments), and prints,
for the shipped kernel and each mutant, the max |diff| against the plain
version and the largest row-relative diff, each beside its bar
(``K5_ATOL``, ``K5_FWD_REL_BF16``), one JSON object a line. Exits 1 if the
shipped kernel fails a bar or a mutant passes the row-relative one.
"""

from __future__ import annotations

import ctypes
import json
import shutil
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
MUTANTS = {
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


def _build_mutant(work: Path, name: str, edits) -> ctypes.CDLL:
    """Patches a copy of the source (and its headers) in the new directory
    ``work`` and builds it with the port's nvcc flags; returns the loaded
    library."""
    src = (build.KERNEL_DIR / "flash_attention.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise ValueError(f"mutant {name!r}: {old!r} is not in flash_attention.cu")
        src = src.replace(old, new)
    work.mkdir()
    for header in build.KERNEL_DIR.glob("*.cuh"):
        shutil.copy(header, work)
    (work / "flash_attention.cu").write_text(src)
    lib_path = work / "lib.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path), str(work / "flash_attention.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"mutant {name!r} did not build:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_segments.argtypes = [p] * 8 + [i] * 4 + [ll] * 12 + [ctypes.c_float, p]
    lib.flash_attention_segments.restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("k5_mutants.py needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(MUTANTS)) as pool:  # one nvcc a mutant, all at once
            built = pool.map(lambda i_kv: _build_mutant(Path(tmp) / str(i_kv[0]), *i_kv[1]), enumerate(MUTANTS.items()))
            libs = dict(zip(MUTANTS, built))
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
    if wrong:
        print(f"bars misjudged: {wrong}", file=sys.stderr)
        return 1
    print("every mutant fails the row-relative bar; the shipped kernel passes both")
    return 0


if __name__ == "__main__":
    sys.exit(main())
