"""Residual against iterations of the WLS solve at realistic sizes (port of
``tools/wls_convergence.py``).

    python -m nct_tpu_torch.tools.wls_convergence [--pair 0] [--size 700]
        [--level 0] [--iters 400] [--device cuda|cpu] [--example DIR]

Measures iterations to tolerance of the Jacobi and multigrid
preconditioners on the real WLS operator of a demo pair at one geometry,
without the matcher: gradient weights from the content's luminance, lam
from the pipeline's schedule at ``--level`` (``wls_lambda_init`` x full
area / level area, x4 at full resolution), and the start from the
patch-moment init (``stats.init_ab``) of the content against the style
resized onto the level grid, upsampled bilinearly.  Per preconditioner one
warm-up solve at tol 1e-2, then tol 1e-2 / 1e-3 / 1e-4, each timed until
the device has finished it.  No VGG runs and nothing is drawn.
Deviations from the JAX tool: ``--device`` (default cuda, raising without
a card) and ``--example`` are added (``tools/demo.py``).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from nct_tpu_torch.config import Config
from nct_tpu_torch.models import vgg19
from nct_tpu_torch.ops.color import bgr_u8_to_lab_u8
from nct_tpu_torch.ops.resize import resize_bilinear
from nct_tpu_torch.solve import stats
from nct_tpu_torch.solve.wls import solve_wls
from nct_tpu_torch.tools import demo
from nct_tpu_torch.tools.bench import resolve_device, sync

TOLS = (1e-2, 1e-3, 1e-4)


def convergence(device, example: str, pair: int = 0, size: int = 700,
                level: int = 0, iters: int = 400, out=demo.say) -> list[dict]:
    """Print the table; returns its rows: {"precond", "tol", "iters",
    "r2", "seconds"} with r2 the final ||r||^2."""
    config = Config()
    cnt, stl = demo.read_pair(example, pair, size)
    h, w = cnt.shape[:2]
    ah, aw = vgg19.feature_dims(h, w)[config.vgg_layers()[level]]

    cnt_d = torch.from_numpy(cnt).to(device)
    cnt_lab_unit = bgr_u8_to_lab_u8(cnt_d).float() / 255.0
    # matcher-free guidance: style resized onto the content's level grid
    down_cnt = resize_bilinear(cnt_d, ah, aw)
    down_stl = resize_bilinear(torch.from_numpy(stl).to(device), ah, aw)
    a_d, b_d = stats.init_ab(bgr_u8_to_lab_u8(down_cnt),
                             bgr_u8_to_lab_u8(down_stl), config.patch_size,
                             config.var_epsilon)
    a_up = resize_bilinear(a_d, h, w)
    b_up = resize_bilinear(b_d, h, w)
    lam = config.wls_lambda_init * (float(h * w) / float(ah * aw))
    if (ah, aw) == (h, w):
        lam *= 4.0

    out(f"pair in{pair} {w}x{h} L{level} grid {aw}x{ah} lam={lam:.3f} "
        f"backend={device.type}")
    out("| preconditioner | tol | iters | final rel-res | wall s |")
    out("|---|---|---|---|---|")
    rows = []
    for pk in ("jacobi", "mg"):
        def solve(tol):
            return solve_wls(a_up, b_up, cnt_lab_unit, lam, config.wls_alpha,
                             iters=iters, tol=tol, precond_kind=pk)
        solve(TOLS[0])           # warm-up
        for tol in TOLS:
            sync(device)
            t0 = time.perf_counter()
            _, _, it, r2 = solve(tol)
            sync(device)
            dt = time.perf_counter() - t0
            rows.append({"precond": pk, "tol": tol, "iters": int(it),
                         "r2": float(r2), "seconds": dt})
            out(f"| {pk} | {tol:g} | {int(it)} | "
                f"{np.sqrt(float(r2)):.3e} (abs) | {dt:.2f} |")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pair", type=int, default=0)
    ap.add_argument("--size", type=int, default=700)
    ap.add_argument("--level", type=int, default=0,
                    help="pyramid level whose lam schedule to use (0..4)")
    ap.add_argument("--iters", type=int, default=400)
    demo.add_options(ap)
    args = ap.parse_args(argv)
    convergence(resolve_device(args.device), demo.example_dir(args.example),
                args.pair, args.size, args.level, args.iters)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
