#!/usr/bin/env python3
"""Variants of the ``lsh_hash`` kernel on one card, timed in turns at the
main path's shapes, and the kernel's error against float64:

    python3 scripts/lsh_variants.py

Each variant is this checkout's ``csrc/lsh_hash.cu`` with one edit, built
with ``nvcc`` into ``build/lsh_variants/`` and called through its C entry
point on the same tensors:

- ``this``: the source as it is;
- ``cvt split``: both operands split with ``cvt.rna.tf32`` in place of
  ``hopper.cuh``'s ``split``, which does the same rounding on the bits;
  its keys must equal this one's bit for bit;
- ``no P split``, ``no wgmma``, ``one product``: ablations whose keys are
  wrong (the split of P skipped; the wgmma replaced by a register update;
  only big x big), timed to show where the time goes;
- ``dots``: the epilogue writes each float32 dot in place of its sign bit,
  held to the float64 product in units of 2^-24 sum_k |x_k P_kj| (the key
  gate admits a flip within d of them), beside cuBLAS's float32 and TF32
  products on the same inputs.

Shapes: the bank fit's chunk (165,376 unit-norm rows, d = 768, H = 10,
M = 16), the centroid fit (1,024 rows, H = 10, M = 10) and the two query
hashes (256 rows). Each variant is timed twice a shape, the variants in
order and then in reverse (CUDA events, the mean of 20 or 200 calls).
Prints the card's name and power limit first; exits non-zero if a build
fails or the keys of ``this`` or ``cvt split`` leave the rounding bound.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHAPES = ((165_376, 768, 10, 16), (1024, 768, 10, 10), (256, 768, 10, 10), (256, 768, 10, 16))
ERROR_SHAPES = ((8, 7, 5), (8, 10, 16), (33, 3, 31), (64, 10, 16), (768, 10, 16), (768, 7, 5))
CORRECT = ("this", "cvt split")


def variants(src: str) -> dict[str, str]:
    def edit(text, old, new, count=1):
        if text.count(old) != count:
            raise RuntimeError(f"lsh_hash.cu no longer holds {old!r} {count} times")
        return text.replace(old, new)

    mma = ("      wgmma_n80(part, a_small[ks], b_big, ks > 0);\n"
           "      wgmma_n80(part, a_big[ks], b_small, 1);\n"
           "      wgmma_n80(part, a_big[ks], b_big, 1);\n")
    bits = ("        bits[(row_w + g + 8 * h) * kN + 8 * j + 2 * t + e] = "
            "acc[4 * j + 2 * h + e] >= 0.0f ? 1 : 0;")
    dots = edit(edit(src, bits,
                     "        { const int col = 8 * j + 2 * t + e;\n"
                     "          const long long row = row0 + row_w + g + 8 * h;\n"
                     "          if (row < n && col < cols)\n"
                     "            reinterpret_cast<float*>(keys)[row * n_arrays * key_len + a0 * key_len"
                     " + col] = acc[4 * j + 2 * h + e]; }"),
                "keys[row * n_arrays + a0 + a] = key;", "(void)key;")
    return {
        "this": src,
        "cvt split": edit(edit(src, "split(", "split_cvt(", 5), '#include "hopper.cuh"\n',
                          '#include "hopper.cuh"\n\nnamespace {\n__device__ __forceinline__ void '
                          "split_cvt(float v, uint32_t& big, uint32_t& small) {\n"
                          '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(v));\n'
                          '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(__fsub_rn(v, __uint_as_float(big))));\n'
                          "}\n}  // namespace\n"),
        "no P split": edit(src, "for (int e = tw; e < kN * 8; e += 128)", "for (int e = tw; e < 0; e += 128)"),
        "no wgmma": edit(src, mma, "      part[ks] += __uint_as_float(a_small[ks][0] ^ a_big[ks][1]);\n"),
        "one product": edit(src, mma, "      wgmma_n80(part, a_big[ks], b_big, ks > 0);\n"),
        "dots": dots,
    }


def build(texts: dict[str, str]) -> dict:
    from repro_torch.kernels import build as kbuild

    out = ROOT / "build" / "lsh_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        (out / f"v{i}.cu").write_text(text)
        cmd = [kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, "-I", str(kbuild.CSRC), "-Xptxas", "-v",
               "-o", str(out / f"libv{i}.so"), str(out / f"v{i}.cu")]
        procs[name] = (out / f"libv{i}.so", subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                             stderr=subprocess.PIPE, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        regs = [line.split("Used ")[1].split(",")[0] for line in err.splitlines() if "Used " in line]
        print(f"{name}: {' / '.join(regs)}", flush=True)
        fn = ctypes.CDLL(str(lib)).lsh_hash_launch
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, I, LL, I, LL, P, LL, I, I, P, P]
        fn.restype = I
        fns[name] = fn
    return fns


def launch(fn, x, p, h, m, out) -> None:
    """The wrapper's padding (16-byte rows for the tensor maps), then the
    C entry point on the current stream."""
    n, d = x.shape
    ld = -(-d // 4) * 4
    xx = torch.nn.functional.pad(x, (0, ld - d)) if ld != d else x
    ld_p = -(-h * m // 4) * 4
    pp = torch.nn.functional.pad(p, (0, ld_p - h * m)) if ld_p != h * m else p
    err = fn(xx.data_ptr(), 0, n, d, ld, pp.data_ptr(), ld_p, h, m, out.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"lsh_hash launch failed with CUDA error {err}")


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def error_units(got, x, p) -> str:
    x64, p64 = x.double(), p.double()
    r = (got.double() - x64 @ p64).abs() / (2.0**-24 * (x64.abs() @ p64.abs()))
    return (f"max {float(r.max()):.3f}, 99.9th percentile "
            f"{float(r.flatten().kthvalue(int(r.numel() * 0.999)).values):.3f}, mean {float(r.mean()):.4f}")


def main() -> int:
    if not torch.cuda.is_available():
        print("lsh_variants: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build as kbuild, ref
    from repro_torch.testing import lsh_key_flips

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    fns = build(variants((kbuild.CSRC / "lsh_hash.cu").read_text()))
    timed = [k for k in fns if k != "dots"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for n, d, h, m in SHAPES:
        x = torch.nn.functional.normalize(torch.randn((n, d), generator=g, device=dev), dim=1)
        p = torch.randn((d, h * m), generator=g, device=dev)
        out = {k: torch.empty((n, h), dtype=torch.int32, device=dev) for k in timed}
        for k in CORRECT:
            launch(fns[k], x, p, h, m, out[k])
        torch.cuda.synchronize()
        want = ref.lsh_hash_ref(x, p, n_arrays=h, key_len=m)
        rep = lsh_key_flips(x, p, h, m, out["this"].long(), want)
        if not torch.equal(out["cvt split"], out["this"]):
            raise AssertionError(f"cvt split and split give other keys at {(n, d, h, m)}")
        reps = 20 if n > 10_000 else 200
        ms = {k: [] for k in timed}
        for order in (timed, timed[::-1]):
            for k in order:
                ms[k].append(cuda_ms(lambda: launch(fns[k], x, p, h, m, out[k]), reps))
        print(f"N={n} d={d} H={h} M={m}: keys of this and cvt split equal, {rep['flips']} of "
              f"{rep['bits']} bits off the plain version's (each within the bound); ms "
              + "; ".join(f"{k} {v[0]:.4f}, {v[1]:.4f}" for k, v in ms.items())
              + f"; cuBLAS float32 product {cuda_ms(lambda: x @ p, reps):.4f}", flush=True)
    for d, h, m in ERROR_SHAPES:
        x = torch.randn((4099, d), generator=g, device=dev)
        p = torch.randn((d, h * m), generator=g, device=dev)
        dots = torch.zeros((4099, h * m), dtype=torch.float32, device=dev)
        launch(fns["dots"], x, p, h, m, dots)
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32 = x @ p
        torch.backends.cuda.matmul.allow_tf32 = False
        print(f"d={d} H={h} M={m}, |error| in 2^-24 sum|x_k P_kj| (the bound is {d}): kernel "
              f"{error_units(dots, x, p)}; cuBLAS float32 {error_units(x @ p, x, p)}; cuBLAS TF32 "
              f"{error_units(tf32, x, p)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
