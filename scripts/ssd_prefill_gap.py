#!/usr/bin/env python3
"""How far the Mamba2-370m bf16 prefill's last logits land from the
training path's forward (the plain scan), by depth, for several scans in
the prefill: where ``chip_smoke.py``'s ``SSD_PREFILL_TOL`` check stands.

    python3 scripts/ssd_prefill_gap.py [--depths 4,12,24,48] [--json PATH]

Random bf16 weights and tokens from seed 0 (as ``chip_smoke.py``'s
``_prefill_vs_plain_scan``: batch 8, 1025 tokens).  For each depth, the
last logits of ``model.logits`` (the plain scan, float32 on the card) are
held against ``model.prefill`` with each of these scans in every layer:

- ``f32_route``: ``ssd_scan`` as the model calls it (the f32 route, on
  the CUDA cores in the plain version's order);
- ``bf16_route``: the bf16 route (tensor cores), named through
  ``ops.launch``;
- ``plain``: ``ssd_scan_plain`` itself (the same arithmetic: expect 0);
- ``plain_f64``: the plain version's formulas in float64 (``scan_f64``,
  written out here), y rounded to bf16 (a more exact scan, in another
  order).

Then, on one layer's inputs at the serve prefill shape (``chip_smoke``'s
``ssd_inputs``, seed 10), the share of bf16 y elements each scan rounds
differently from y computed in float64 and rounded once.  Needs one CUDA
card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
from chip_smoke import card_line, ssd_inputs  # noqa: E402


def scan_f64(xs, dt, a_log, bs, cs, chunk):
    """``ssd_scan_plain``'s formulas in float64, chunk by chunk; y in xs's
    dtype, the final state float32."""
    import torch
    import torch.nn.functional as F

    b, s, h, p = xs.shape
    r = h // bs.shape[2]
    f = torch.float64
    pad = -s % chunk
    x_, d_, b_, c_ = (F.pad(t.to(f), (0, 0) * (t.dim() - 2) + (0, pad))
                      for t in (xs, dt, bs, cs))
    b_, c_ = (t.repeat_interleave(r, dim=2) for t in (b_, c_))
    a = -torch.exp(a_log.to(f))
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=xs.device).tril()
    state = torch.zeros(b, h, p, bs.shape[3], dtype=f, device=xs.device)
    ys = []
    for c0 in range(0, s + pad, chunk):
        xc, dc = x_[:, c0:c0 + chunk], d_[:, c0:c0 + chunk]
        bc, cc = b_[:, c0:c0 + chunk], c_[:, c0:c0 + chunk]
        lt = torch.cumsum(dc * a, dim=1).transpose(1, 2)       # (B,H,Q)
        rel = torch.clamp(lt[..., :, None] - lt[..., None, :], max=0.0)
        m = torch.where(causal, torch.einsum("bihn,bjhn->bhij", cc, bc)
                        * torch.exp(rel), 0.0) \
            * dc.transpose(1, 2)[:, :, None, :]
        ys.append(torch.einsum("bqhn,bhpn->bqhp", cc, state)
                  * torch.exp(lt).transpose(1, 2)[..., None]
                  + torch.einsum("bhij,bjhp->bihp", m, xc))
        w = torch.exp(lt[..., -1:] - lt) * dc.transpose(1, 2)  # (B,H,Q)
        state = state * torch.exp(lt[..., -1])[..., None, None] \
            + torch.einsum("bhq,bqhn,bqhp->bhpn", w, bc, xc)
    return torch.cat(ys, dim=1)[:, :s].to(xs.dtype), state.float()


def scans():
    from repro_torch.kernels.ssd_scan import ops, ssd_scan, ssd_scan_plain

    def bf16_route(*args):
        return ops.launch(*args, "bf16")

    return {"f32_route": ssd_scan, "bf16_route": bf16_route,
            "plain": ssd_scan_plain, "plain_f64": scan_f64}


def logit_gaps(torch, dev, depth: int) -> dict:
    import numpy as np

    import repro_torch.models.ssm as ssm
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("mamba2-370m").replace(num_layers=depth)
    model = build_model(cfg)
    params = model.init(0, dev, dtype=torch.bfloat16)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (8, 1025)).astype(np.int32)).to(dev)
    out = {}
    kept = ssm.ssd_scan
    try:
        with torch.no_grad():
            want = model.logits(params, toks)[:, -1].float()
            for name, fn in scans().items():
                ssm.ssd_scan = fn
                got, _ = model.prefill(params, {"tokens": toks})
                out[name] = (got.float() - want).abs().max().item()
    finally:
        ssm.ssd_scan = kept
    del params
    torch.cuda.empty_cache()
    return out


def flip_shares(torch, dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(10)
    args = ssd_inputs(torch, dev, 8, 1024, 32, 1, torch.bfloat16, gen)
    exact, _ = scan_f64(*args, 256)
    out = {}
    for name, fn in scans().items():
        if name == "plain_f64":
            continue
        y, _ = fn(*args, 256)
        out[name] = (y != exact).float().mean().item()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--depths", default="4,12,24,48")
    ap.add_argument("--json", type=Path)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rec = {"card": card_line(), "logit_gap_vs_plain": {}}
    print(rec["card"], flush=True)
    for d in (int(x) for x in args.depths.split(",")):
        rec["logit_gap_vs_plain"][d] = logit_gaps(torch, dev, d)
        print(json.dumps({"depth": d, **rec["logit_gap_vs_plain"][d]}),
              flush=True)
    rec["y_flip_share_vs_f64"] = flip_shares(torch, dev)
    print(json.dumps({"y_flip_share_vs_f64": rec["y_flip_share_vs_f64"]}),
          flush=True)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
