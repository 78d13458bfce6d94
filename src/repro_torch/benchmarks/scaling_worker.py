"""Figures 1-2's worker (counterpart of the JAX harness's
``benchmarks/scaling_worker.py``): what one rank of the column-sharded
``rid_distributed`` does at N ranks, counted on torch's fake backend.

The reference lowers the whole program on a fake N-device XLA mesh and
reads XLA's cost analysis.  Here rank 0 of torch's fake process group at
world N (``launch.dryrun.join_fake_group``) runs the port's
``rid_distributed`` (gaussian sketch, f32 ``A`` of ``(m, n)``, the given
``qr_impl``) on its own ``m x n/N`` column block, once, under
``FakeTensorMode``: every tensor is a shape and a dtype, nothing is
allocated, so the paper's 64 GB rows run on a laptop.  A dispatch meter
(``launch.dryrun._Meter``) counts per device:

  * ``flops``            -- the matrix products' (torch's flop counter's
                            convention: elementwise arithmetic is not
                            counted), with formulas for the three ops the
                            ID reaches that torch's registry lacks:
                            ``mv`` (CGS2's projections, 2 m n),
                            ``linalg_solve_triangular`` (the
                            interpolation solve, k^2 n) and
                            ``linalg_cholesky_ex`` (the 'gram' oracle's,
                            b^3 / 3);
  * ``bytes``            -- bytes accessed: each local op's operands and
                            results (views, allocations and metadata
                            queries move nothing);
  * ``collective_bytes`` -- the result bytes of every collective, the
                            c10d in-place ones included, by kind, and
                            ``interhost_bytes``: those of groups that span
                            hosts of ``CARDS_PER_HOST`` cards;
  * ``bytes_per_device`` -- the peak of live storage, ``A``'s block
                            included.

The ID's kernels (``KERNEL_COSTS``): on CPU tensors their ``ops.py``
entries run the plain ``ref.py`` steps, which are not what the card runs;
each call is counted as the kernel's own work instead -- the operations
and bytes of its bound in PERF.md section 6 -- and the plain steps inside
it do not run (the call gives empty results of the kernel's shapes).

Two host reads of the program depend on data, and a fake tensor has none:
``global_columns`` reads the ranks' shard widths (``int()``), and
``_panel_ok`` one flag a panel (``bool()``).  The meter answers them:
every rank holds ``n/N`` columns, and the panel is orthonormal, the
branch the card takes unless a panel collapses.  The row counts them
(``host_reads``); any other read raises, so a new data-dependent read in
the ID fails here instead of being answered silently.

``model_time`` (the roofline time of one rank) uses the H100's published
constants, ``H100`` below.  ``--exec`` also runs the row for real: on
``--device cpu`` on ``nproc`` gloo ranks (``OMP_NUM_THREADS=1``), on
``--device cuda`` one rank a card over NCCL; ``wall_s`` is rank 0's
median of 3 timed calls after one warm-up.

  python -m repro_torch.benchmarks.scaling_worker K M N PROCS [QR_IMPL] \\
      [--exec] [--device cuda|cpu]

``N`` and ``PROCS`` may be comma lists (one ``n`` a proc count, or one
``n`` for all): one process sweeps them all, re-joining the fake group at
each world size.  Prints one JSON record a proc count.
"""
from __future__ import annotations

import contextlib
import importlib
import json
import os
import subprocess
import sys
import tempfile

import torch
import torch.distributed as dist

from ..launch.dryrun import CARDS_PER_HOST

__all__ = ["H100", "CARDS_PER_HOST", "KERNEL_COSTS",
           "measure", "model_time", "exec_wall", "sweep"]

# The H100 SXM5's published rates (NVIDIA H100 Tensor Core GPU datasheet;
# DGX H100 user guide for the network).  PERF.md section 2 writes the
# card's name and power limit beside every figure they model.
H100 = {
    "name": "h100-sxm5",
    # FP32 outside the tensor cores: the ID's f32 sums are IEEE FFMA.
    "peak_flops": 67e12,
    # HBM3, 80 GB.
    "hbm_bytes_s": 3.35e12,
    # NVLink 4 between the 8 cards of a host: 900 GB/s both ways.
    "nvlink_bytes_s": 450e9,
    # Beyond a host: DGX H100's one 400 Gb/s NDR InfiniBand port a card.
    "net_bytes_s": 50e9,
    "source": "H100 SXM5 datasheet: 67 TFLOP/s FP32, 3.35 TB/s HBM3, "
              "NVLink 900 GB/s; DGX H100: one 400 Gb/s NDR port a card",
}
QR_IMPLS = ("cgs2", "blocked", "panel_parallel")

# Where the ID calls its kernels' ops.py entries (module, name).
_KERNEL_SITES = (("repro_torch.core.sketch", "sketch_accum"),
                 ("repro_torch.core.qr", "panel_step"),
                 ("repro_torch.core.qr_dist", "panel_coeff"),
                 ("repro_torch.core.qr_dist", "panel_apply"),
                 ("repro_torch.core.qr_dist", "panel_gram"))


def _mul(t: torch.Tensor) -> int:
    """Real operations of one multiply-add: 2, or 8 for complex."""
    return 8 if t.dtype.is_complex else 2


def _factor_flops(l: int, b: int) -> float:
    """A panel's factor: 2 rounds of Gram (2 l b^2), Cholesky (b^3 / 3)
    and solve (l b^2)."""
    return 2 * (3.0 * l * b * b + b ** 3 / 3)


def _sketch_accum_cost(x, a, acc=None):
    l, m = x.shape
    n = a.shape[1]
    e = x.element_size()
    return (_mul(x) * l * m * n,
            e * (l * m + m * n + l * n * (1 if acc is None else 2)))


def _panel_step_cost(c, z, **_):
    (l, b), n = c.shape, z.shape[1]
    return (_factor_flops(l, b) + 2 * _mul(c) * l * b * n + 2.0 * l * n,
            c.element_size() * (2 * l * b + 2 * l * n + n))


def _panel_coeff_cost(c, z, res2):
    (l, b), n = c.shape, z.shape[1]
    return (_factor_flops(l, b) + _mul(c) * l * b * n + 2.0 * b * n,
            c.element_size() * (2 * l * b + l * n + b * n + 2 * n))


def _panel_apply_cost(qp, w, z, emit_norms=False):
    (l, b), n = qp.shape, z.shape[1]
    e = qp.element_size()
    return (_mul(qp) * l * b * n + (2.0 * l * n if emit_norms else 0.0),
            e * (l * b + b * n + 2 * l * n + (n if emit_norms else 0)))


def _panel_gram_cost(c, z):
    (l, b), n = c.shape, z.shape[1]
    return (_mul(c) * l * b * (n + b),
            c.element_size() * (l * b + l * n + b * b + b * n))


def _real(t: torch.Tensor) -> torch.dtype:
    return t.dtype.to_real() if t.dtype.is_complex else t.dtype


def _sketch_accum_out(x, a, acc=None):
    from ..kernels.sketch_accum import accum_dtype_for
    return torch.empty((x.shape[0], a.shape[1]), dtype=accum_dtype_for(
        torch.promote_types(x.dtype, a.dtype)))


def _panel_step_out(c, z, emit_w=True):
    (l, b), n = c.shape, z.shape[1]
    return (torch.empty((l, b), dtype=c.dtype),
            torch.empty((l, n), dtype=c.dtype),
            torch.empty((b, n), dtype=c.dtype) if emit_w else None,
            torch.empty((n,), dtype=_real(c)))


def _panel_coeff_out(c, z, res2):
    (l, b), n = c.shape, z.shape[1]
    return (torch.empty((l, b), dtype=c.dtype),
            torch.empty((b, n), dtype=c.dtype),
            torch.empty((n,), dtype=_real(c)))


def _panel_apply_out(qp, w, z, emit_norms=False):
    o = torch.empty(z.shape, dtype=z.dtype)
    return (o, torch.empty((z.shape[1],), dtype=_real(z))) if emit_norms \
        else o


def _panel_gram_out(c, z):
    b, n = c.shape[1], z.shape[1]
    return (torch.empty((b, b), dtype=c.dtype),
            torch.empty((b, n), dtype=c.dtype))


# ops.py entry -> (its (operations, bytes): PERF.md section 6's bound
# column, each input read once and each output written once; its results,
# as empty tensors of their shapes and dtypes).
KERNEL_COSTS = {"sketch_accum": (_sketch_accum_cost, _sketch_accum_out),
                "panel_step": (_panel_step_cost, _panel_step_out),
                "panel_coeff": (_panel_coeff_cost, _panel_coeff_out),
                "panel_apply": (_panel_apply_cost, _panel_apply_out),
                "panel_gram": (_panel_gram_cost, _panel_gram_out)}


def _mv_flops(a_shape, x_shape, *_, **__):
    return 2 * a_shape[0] * a_shape[1]


def _solve_triangular_flops(a_shape, b_shape, *_, **__):
    # k(k+1)/2 multiply-adds a right-hand side: k^2 n.
    k, n = a_shape[-1], b_shape[-1]
    return k * k * n


def _cholesky_flops(a_shape, *_, **__):
    return a_shape[-1] ** 3 // 3


def _formula(shape_fn):
    """A flop formula over the shapes of an op's tensor arguments (torch's
    registry's calling convention: the args, then ``out_val``)."""
    def formula(*args, out_val=None, **kwargs):
        shapes = [a.shape for a in args if isinstance(a, torch.Tensor)]
        return shape_fn(*shapes)
    return formula


def _flop_formulas() -> dict:
    aten = torch.ops.aten
    return {aten.mv: _formula(_mv_flops),
            aten.linalg_solve_triangular: _formula(_solve_triangular_flops),
            aten.linalg_cholesky_ex: _formula(_cholesky_flops)}


@contextlib.contextmanager
def _kernels_at_their_bound(meter, calls: dict):
    """Count each call of an ID kernel's ops.py entry as the kernel's own
    work (``KERNEL_COSTS``), not the plain steps it would run on the CPU:
    under ``FakeTensorMode`` the call gives empty results of the kernel's
    shapes, and the plain steps do not run."""
    from torch.utils._pytree import tree_leaves
    saved = []

    def wrap(name):
        cost, results = KERNEL_COSTS[name]

        def counted(*args, **kwargs):
            meter.paused += 1
            try:
                out = results(*args, **kwargs)
            finally:
                meter.paused -= 1
            flops, nbytes = cost(*args, **kwargs)
            meter.flops += int(flops)
            meter.bytes += int(nbytes)
            calls[name] = calls.get(name, 0) + 1
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    meter.track(t, name)
            return out
        return counted

    try:
        for modname, name in _KERNEL_SITES:
            mod = importlib.import_module(modname)
            fn = getattr(mod, name)
            saved.append((mod, name, fn))
            setattr(mod, name, wrap(name))
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _join(world: int) -> None:
    """Rank 0 of the fake backend at ``world`` (re-joined at a new size)."""
    from ..launch.dryrun import join_fake_group
    if dist.is_initialized():
        if (dist.get_backend() == "fake"
                and dist.get_world_size() == world):
            return
        if dist.get_backend() != "fake":
            raise RuntimeError("the worker joins the fake backend, and this "
                               "process is in another group already")
        dist.destroy_process_group()
    join_fake_group(world)


def measure(k: int, m: int, n: int, nproc: int,
            qr_impl: str = "blocked") -> dict:
    """One rank's counts for ``rid_distributed`` of an f32 ``(m, n)`` at
    ``nproc`` ranks (module docstring).  Joins the fake backend: run it
    in a process of its own (``sweep``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from ..core.distributed import rid_distributed
    from ..launch.dryrun import _Meter
    if qr_impl not in QR_IMPLS:
        raise ValueError(f"unknown qr impl {qr_impl!r}; expected one of "
                         f"{QR_IMPLS}")
    if n % nproc:
        raise ValueError(f"n={n} must divide over {nproc} ranks")
    _join(nproc)
    reads = {"shard_widths": 0, "panel_ok": 0}

    def answer(t: torch.Tensor):
        if t.dtype == torch.int64 and t.numel() == 1:
            reads["shard_widths"] += 1
            return n // nproc
        if t.dtype == torch.bool and t.numel() == 1:
            reads["panel_ok"] += 1
            return True
        raise RuntimeError(f"a data-dependent host read of a {t.dtype} "
                           f"tensor of shape {tuple(t.shape)}: the worker "
                           f"answers only the shard widths and the panel "
                           f"check")

    calls: dict = {}
    with FakeTensorMode(allow_non_fake_inputs=True), \
            _Meter(nproc, answer=answer,
                   flop_formulas=_flop_formulas()) as meter, \
            _kernels_at_their_bound(meter, calls):
        A_loc = torch.empty((m, n // nproc), dtype=torch.float32)
        meter.track(A_loc)
        meter.reset_peak()
        dec = rid_distributed(0, A_loc, k, group=dist.group.WORLD,
                              sketch_kind="gaussian", qr_impl=qr_impl)
        shapes = [list(dec.B.shape), list(dec.P.shape)]
        del dec
        meter._sweep()
    coll = dict(sorted(meter.coll.items()))
    return {"nproc": nproc, "k": k, "m": m, "n": n, "qr_impl": qr_impl,
            "flops": float(meter.flops), "bytes": float(meter.bytes),
            "collective_bytes": float(sum(coll.values())),
            "collective_by_kind": coll,
            "interhost_bytes": float(meter.interhost),
            "bytes_per_device": float(meter.peak),
            "host_reads": reads, "kernel_calls": dict(sorted(calls.items())),
            "out_shapes": shapes, "wall_s": None}


def model_time(rec: dict) -> float:
    """One rank's roofline seconds on ``H100``: the largest of its flops
    over the peak, its bytes over HBM, and its collectives over the links
    (NVLink within a host, the network for groups that span hosts)."""
    coll = rec["collective_bytes"]
    inter = rec.get("interhost_bytes", 0.0)
    return max(rec["flops"] / H100["peak_flops"],
               rec["bytes"] / H100["hbm_bytes_s"],
               (coll - inter) / H100["nvlink_bytes_s"]
               + inter / H100["net_bytes_s"])


def exec_wall(k: int, m: int, n: int, qr_impl: str, group,
              device) -> float:
    """Median seconds of 3 calls of ``rid_distributed`` on this rank of
    ``group`` (every rank calls it) on an f32 gaussian ``A`` of ``(m, n)``,
    after one untimed call; each rank draws its own block."""
    from ..core.distributed import rid_distributed
    from .common import randn, time_fn
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if n % world:
        raise ValueError(f"n={n} must divide over {world} ranks")
    gen = torch.Generator(device=device).manual_seed(1000 + rank)
    A_loc = randn(gen, (m, n // world), torch.float32, device)

    def run():
        return rid_distributed(0, A_loc, k, group=group,
                               sketch_kind="gaussian", qr_impl=qr_impl)
    return time_fn(run, warmup=1, iters=3)


_EXEC_RANK = r"""
import json, sys
import torch
import torch.distributed as dist
rank, world, store, device = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
k, m, n, qr_impl = (int(sys.argv[5]), int(sys.argv[6]), int(sys.argv[7]),
                    sys.argv[8])
if device == "cuda":
    torch.cuda.set_device(rank)
dist.init_process_group("nccl" if device == "cuda" else "gloo",
                        init_method=f"file://{store}", rank=rank,
                        world_size=world)
from repro_torch.benchmarks.scaling_worker import exec_wall
try:
    wall = exec_wall(k, m, n, qr_impl, dist.group.WORLD,
                     torch.device(device, rank) if device == "cuda"
                     else device)
    if rank == 0:
        print(json.dumps({"wall_s": wall}))
finally:
    dist.destroy_process_group()
"""


def _src_path() -> str:
    return os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                        ".."))


def _exec_ranks(k: int, m: int, n: int, nproc: int, qr_impl: str,
                device: str) -> float:
    """Run the row for real on ``nproc`` rank processes (gloo on the CPU,
    one rank a card over NCCL) and return rank 0's ``wall_s``."""
    if device == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if nproc > have:
            raise RuntimeError(f"--exec on cuda runs one rank a card: "
                               f"{nproc} ranks, {have} cards")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = _src_path() + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, "-c", _EXEC_RANK, str(r), str(nproc), store,
             device, str(k), str(m), str(n), qr_impl], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(nproc)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=1800))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    bad = [(r, p.returncode, err[-2000:])
           for r, (p, (_, err)) in enumerate(zip(procs, outs))
           if p.returncode != 0]
    if bad:
        raise RuntimeError(f"--exec ranks failed: {bad}")
    return json.loads(outs[0][0].strip().splitlines()[-1])["wall_s"]


def sweep(k: int, m: int, ns, procs, qr_impl: str = "blocked", *,
          exec_on: str | None = None) -> list[dict]:
    """The records of ``measure`` for each ``(n, nproc)`` of ``ns`` and
    ``procs`` (``ns`` one int for all, or one a proc count), from one
    subprocess that re-joins the fake group at each world size; with
    ``exec_on`` (a device, ``"cuda"`` or ``"cpu"``) each row is also run
    for real there (``wall_s``)."""
    ns = [ns] * len(procs) if isinstance(ns, int) else list(ns)
    if len(ns) != len(procs):
        raise ValueError(f"ns: one n a proc count ({len(procs)}), or one "
                         f"n for all; got {len(ns)}")
    args = [str(k), str(m), ",".join(map(str, ns)),
            ",".join(map(str, procs)), qr_impl]
    if exec_on is not None:
        args += ["--exec", "--device", exec_on]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = _src_path() + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-m",
                        "repro_torch.benchmarks.scaling_worker", *args],
                       capture_output=True, text=True, env=env,
                       timeout=3600)
    if r.returncode != 0:
        raise RuntimeError(r.stderr[-3000:])
    return [json.loads(line) for line in r.stdout.splitlines()
            if line.startswith("{")]


def main(argv=None) -> int:
    from .common import cli_parser
    ap = cli_parser("Figures 1-2's worker: one rank of rid_distributed at "
                    "N ranks, counted on torch's fake backend")
    ap.add_argument("k", type=int)
    ap.add_argument("m", type=int)
    ap.add_argument("n", help="columns (a comma list: one a proc count)")
    ap.add_argument("procs", help="rank counts (comma list)")
    ap.add_argument("qr_impl", nargs="?", default="blocked",
                    choices=QR_IMPLS)
    ap.add_argument("--exec", dest="do_exec", action="store_true",
                    help="also run each row for real and record wall_s")
    args = ap.parse_args(argv)
    procs = [int(p) for p in args.procs.split(",")]
    ns = [int(x) for x in args.n.split(",")]
    ns = ns * len(procs) if len(ns) == 1 else ns
    for n, p in zip(ns, procs, strict=True):
        rec = measure(args.k, args.m, n, p, args.qr_impl)
        if args.do_exec:
            rec["wall_s"] = _exec_ranks(args.k, args.m, n, p, args.qr_impl,
                                        args.device)
        print(json.dumps(rec), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
