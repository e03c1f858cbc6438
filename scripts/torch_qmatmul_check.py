#!/usr/bin/env python3
"""A quick check of the port's dequant-matmul (B2) alone, on one GPU.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/torch_qmatmul_check.py

It builds ``csrc/qmatmul.cu`` and prints its register report and the
tensor-core (``HMMA``) instructions of each kernel in its SASS, then, for
each of the ten block formats: the kernel against its plain version at
two Llama-2-7B weight shapes (gate_up 4096x22016, down 11008x4096) and
two narrow ones whose K is padded (200x72, 320x200), at M = 1 and 8 (the
GEMV instance) and 9, 16, 17, 32, 100 and 128 (the tiled one), bf16 out
and, at the narrow shapes, fp32 out (each output row within one bf16 ulp
of its largest value: "ok" or "BAD"); the codec on the card against the
CPU at 1024x512 (data, scales, zeros byte-equal); and the kernel's time at
gate_up M=8 and M=128 (CUDA events over 50 launches of one weight, so
partly from L2).  The full check of the port is ``chip_smoke.py``.
"""

from __future__ import annotations

import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from ipex_llm_tpu_torch.ops.cuda import _build
    from ipex_llm_tpu_torch.ops.cuda import qmatmul as b2
    from ipex_llm_tpu_torch.quantize.core import quantize

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout, torch.__version__,
          torch.version.cuda)
    t = time.perf_counter()
    _build.build([b2.NAME])
    print("build", time.perf_counter() - t)
    print("\n".join(ln for ln in (_build.BUILD_DIR / "qmatmul.log")
                    .read_text().splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Compiling entry" in ln))
    for fn, n in sorted(_build.sass_counts(b2.NAME).items()):
        print("HMMA", n, fn)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    bad = 0
    for q in b2.FORMATS:
        for k, n in ((4096, 22016), (11008, 4096), (200, 72), (320, 200)):
            wq = quantize(torch.randn(k, n, generator=g, device=dev)
                          * (1.2 / math.sqrt(k)), q)
            num, den = b2.data_row_factor(q)
            kp = wq.data.shape[0] * num // den
            for m in (1, 8, 9, 16, 17, 32, 100, 128):
                x = torch.randn(m, kp, generator=g, device=dev).to(
                    torch.bfloat16)
                for f32 in (False, True) if k < 1024 else (False,):
                    y = b2.qmatmul(x, wq, keep_f32=f32)
                    yp = b2.qmatmul_plain(x, wq, keep_f32=f32)
                    torch.cuda.synchronize()
                    err = (y.float() - yp.float()).abs().amax(1)
                    top = yp.float().abs().amax(1)
                    ok = bool((err <= 2 ** -7 * top).all()) and bool(
                        torch.isfinite(y).all())
                    bad += not ok
                    print(q, k, n, m, b2.plan(m, n, kp, wq.block_size),
                          "f32" if f32 else "bf16", "ok" if ok else "BAD",
                          float((err / top.clamp_min(1e-30)).max()))
        w = torch.randn(1024, 512, generator=g, device=dev) * 0.03
        a, c = quantize(w, q), quantize(w.cpu(), q)
        eq = [(u is None and v is None) or bool(
            (u.cpu().view(torch.uint8) == v.view(torch.uint8)).all())
            for u, v in ((a.data, c.data), (a.scales, c.scales),
                         (a.zeros, c.zeros))]
        bad += not all(eq)
        print("codec", q, eq)
        wq = quantize(torch.randn(4096, 22016, generator=g, device=dev)
                      * (1.2 / 64), q)
        for m in (8, 128):
            x = torch.randn(m, 4096, generator=g, device=dev).to(
                torch.bfloat16)
            st = torch.cuda.Event(enable_timing=True)
            en = torch.cuda.Event(enable_timing=True)
            b2.qmatmul(x, wq)
            st.record()
            for _ in range(50):
                b2.qmatmul(x, wq)
            en.record()
            en.synchronize()
            print(f"time gate_up M={m}", q, st.elapsed_time(en) / 50,
                  "bytes", wq.nbytes)
    print("launches", b2.COUNTS.launches, b2.COUNTS.by_format,
          b2.COUNTS.by_route)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
