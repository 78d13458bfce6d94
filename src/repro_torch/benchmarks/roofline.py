"""Roofline table of the port's dry-run (counterpart of the JAX harness's
``benchmarks/roofline.py``): reads ``experiments/dryrun_torch/*.json``
(``repro_torch.launch.dryrun``'s records, under the reference's keys) and
derives, per (arch x shape x mesh), one rank's

  compute term    = flops / peak                       [s]
  memory term     = bytes_accessed / HBM               [s]
  collective term = NVLink bytes / NVLink + the bytes of groups that
                    span hosts / network               [s]
  interpod term   = interpod_bytes / network           [s]

and MODEL_FLOPS = 6 N D (2 N D for prefill and decode; active N for MoE)
with the useful-compute ratio MODEL_FLOPS / flops.  The dry-run counts
every layer (no extrapolation), so the records' plain keys stand.

The H100 SXM5's published constants: 989 TFLOP/s dense bf16 on the
tensor cores, 3.35 TB/s HBM3; the links of ``scaling_worker.H100``
(NVLink 4, 450 GB/s each way within a host of 8 cards; DGX H100's one
400 Gb/s NDR port a card, 50 GB/s, beyond it).  These model a cluster
the records describe; no multi-card run stands behind them.

  python -m repro_torch.benchmarks.roofline [--pattern GLOB] [--csv]

(``--device`` and ``--full``, the bench CLIs' common flags, change
nothing here.)
"""
from __future__ import annotations

import glob
import json
import os

from ..configs import get_config
from ..launch.dryrun import ARTIFACT_DIR
from ..launch.shapes import SHAPES
from .common import cli_parser
from .scaling_worker import H100

__all__ = ["PEAK", "HBM", "LINK", "NET", "model_flops", "chips",
           "load_records", "analyze_record", "table", "main"]

# Dense bf16 on the tensor cores (H100 SXM5 datasheet).
PEAK = 989e12
HBM = H100["hbm_bytes_s"]
LINK = H100["nvlink_bytes_s"]
NET = H100["net_bytes_s"]

ART_DIR = ARTIFACT_DIR


def model_flops(arch: str, shape: str) -> float:
    cfg = get_config(arch)
    case = SHAPES[shape]
    n_active = cfg.param_count(active_only=True)
    if case.kind == "train":
        return 6.0 * n_active * case.global_batch * case.seq_len
    if case.kind == "prefill":
        return 2.0 * n_active * case.global_batch * case.seq_len
    return 2.0 * n_active * case.global_batch          # decode: 1 token/seq


def chips(mesh: str) -> int:
    return 512 if mesh == "multipod" else 256


def load_records(pattern: str = "*") -> list[dict]:
    recs = []
    for fn in sorted(glob.glob(os.path.join(ART_DIR, f"{pattern}.json"))):
        with open(fn) as f:
            recs.append(json.load(f))
    return recs


def analyze_record(r: dict) -> dict | None:
    if r.get("status") != "ok":
        return None
    fl = max(r.get("flops", 0.0), 0.0)
    by = max(r.get("bytes_accessed", 0.0), 0.0)
    co = max(r.get("collective_total", 0.0), 0.0)
    ip = max(r.get("interpod_bytes", 0.0), 0.0)
    ih = min(max(r.get("interhost_bytes", 0.0), ip), co)
    t_c = fl / PEAK
    t_m = by / HBM
    t_x = (co - ih) / LINK + ih / NET
    dom = max((t_c, "compute"), (t_m, "memory"), (t_x, "collective"))[1]
    mf_dev = model_flops(r["arch"], r["shape"]) / chips(r["mesh"])
    useful = mf_dev / fl if fl else 0.0
    # roofline fraction: useful model flops per chip over the time the
    # dominant term implies, as a fraction of peak
    t_dom = max(t_c, t_m, t_x)
    frac = (mf_dev / PEAK) / t_dom if t_dom else 0.0
    return dict(arch=r["arch"], shape=r["shape"], mesh=r["mesh"],
                compress=r.get("compress", False),
                mode=r.get("mode", "tp"),
                compute_s=t_c, memory_s=t_m, collective_s=t_x,
                interpod_s=ip / NET,
                dominant=dom, model_flops_per_chip=mf_dev,
                useful_ratio=useful, roofline_fraction=frac)


def table(recs: list[dict], *, markdown: bool = True) -> str:
    rows = [a for a in (analyze_record(r) for r in recs) if a]
    rows.sort(key=lambda a: (a["arch"], a["shape"], a["mesh"],
                             a["mode"], a["compress"]))
    hdr = ["arch", "shape", "mesh", "mode", "rcmp", "compute_s", "memory_s",
           "collective_s", "interpod_s", "dominant", "useful", "roofline%"]
    lines = []
    if markdown:
        lines.append("| " + " | ".join(hdr) + " |")
        lines.append("|" + "---|" * len(hdr))
    for a in rows:
        cells = [a["arch"], a["shape"], a["mesh"], a["mode"],
                 "y" if a["compress"] else "",
                 f"{a['compute_s']:.3e}", f"{a['memory_s']:.3e}",
                 f"{a['collective_s']:.3e}", f"{a['interpod_s']:.3e}",
                 a["dominant"],
                 f"{a['useful_ratio']:.2f}",
                 f"{100 * a['roofline_fraction']:.1f}"]
        lines.append("| " + " | ".join(cells) + " |" if markdown
                     else ",".join(cells))
    return "\n".join(lines)


def main(argv=None):
    # (the common flags: --device and --full change nothing here, the
    # records are read from disk)
    ap = cli_parser("Roofline table of the port's dry-run records")
    ap.add_argument("--pattern", default="*")
    ap.add_argument("--csv", action="store_true")
    args = ap.parse_args(argv)
    recs = load_records(args.pattern)
    if not recs:
        print("no dry-run artifacts found — run "
              "repro_torch.launch.dryrun first")
        return
    print(table(recs, markdown=not args.csv))


if __name__ == "__main__":
    main()
