"""The four attention-only configurations ported beside the MoE FFN
(qwen2-moe-a2.7b, phi3.5-moe-42b-a6.6b, qwen3-8b, qwen2-7b) against the
JAX reference's, and the SMOKE qwen3-8b (qk-norm, head_dim 16 over d_model
64) and qwen2-7b (QKV bias, d_model 56) served on the CPU.

Both packages run the same weights (drawn by the port, carried across as
the reference's tree by ``params_to_numpy`` / ``params_from_jax``) in f32
compute on seeded numpy tokens; the reference's functions under
``jax.jit``.  Tolerance: 1e-4 of the largest entry of the reference's
logits (f32 sums in another order through two layers).
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.kernels.flash.kernel import LAUNCHES  # noqa: E402
from torch_ranks import pin_threads  # noqa: E402

pin_threads()

TOL = 1e-4
NEW = {"qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
       "phi3.5-moe-42b-a6.6b": "phi35_moe",
       "qwen3-8b": "qwen3_8b", "qwen2-7b": "qwen2_7b"}
DENSE = ["qwen3_8b", "qwen2_7b"]


def _close(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"max |got - want| = {err} > {TOL} * {scale}"


@pytest.mark.parametrize("alias", sorted(NEW))
def test_configs_equal_the_reference(alias):
    """CONFIG and SMOKE field for field, by alias and by module name, and
    the reference's parameter counts (qwen2-moe's 1.432e10 at full width
    and depth, the size the card serves)."""
    for name in (alias, NEW[alias]):
        for getter in ("get_config", "get_smoke_config"):
            want = getattr(jcfgs, getter)(name)
            got = getattr(tcfgs, getter)(name)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.param_count() == want.param_count()
            assert got.param_count(True) == want.param_count(True)
    assert NEW[alias] in tcfgs.ARCHS


def test_the_remaining_archs_still_raise():
    """None does: xlstm-125m, whisper-tiny and qwen2-vl-2b resolve to the
    reference's CONFIG and SMOKE field for field, with its parameter
    counts, by alias and by module name."""
    for alias, name in (("xlstm-125m", "xlstm_125m"),
                        ("whisper-tiny", "whisper_tiny"),
                        ("qwen2-vl-2b", "qwen2_vl_2b")):
        for arch in (alias, name):
            for getter in ("get_config", "get_smoke_config"):
                want = getattr(jcfgs, getter)(arch)
                got = getattr(tcfgs, getter)(arch)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
                assert got.param_count() == want.param_count()
    assert tcfgs.get_config("qwen2-moe-a2.7b").param_count() == 14_316_011_520
    assert tcfgs.get_config("qwen2-vl-2b").param_count() == 1_543_766_016


@pytest.fixture(scope="module", params=DENSE)
def pair(request):
    """The port's init moved into the reference's tree (the reference's own
    init would compile for each config) and back through
    ``params_from_jax``."""
    jc = jcfgs.get_smoke_config(request.param).replace(dtype="float32")
    tc = tcfgs.get_smoke_config(request.param).replace(dtype="float32")
    jp = tmodels.params_to_numpy(tmodels.init_params(0, tc, device="cpu"))
    model = tmodels.params_from_jax(jp, tc, device="cpu")
    return jc, jax.tree.map(jnp.asarray, jp), tc, model


def test_dense_smoke_forward_matches(pair):
    jc, jp, tc, model = pair
    toks = np.random.default_rng(0).integers(
        0, jc.vocab_size, (2, 20)).astype(np.int32)
    want, _ = jax.jit(lambda p, t: jmodels.forward(p, jc, t))(
        jp, jnp.asarray(toks))
    got, aux = tmodels.forward(model, tc, torch.from_numpy(toks))
    _close(got, want)
    assert float(aux.load_balance_loss) == 0.0


def test_dense_smoke_prefill_and_decode_match(pair):
    """Prefill of 9 tokens (batch 2) and 3 greedy decode steps."""
    jc, jp, tc, model = pair
    toks = np.random.default_rng(1).integers(
        0, jc.vocab_size, (2, 9)).astype(np.int32)
    jl, jcache = jax.jit(lambda p, t: jmodels.prefill(p, jc, t, max_len=16))(
        jp, jnp.asarray(toks))
    jdecode = jax.jit(lambda p, t, pos, c: jmodels.decode_step(p, jc, t, pos,
                                                                c))
    before = LAUNCHES.count
    tl, tcache = tmodels.prefill(model, tc, torch.from_numpy(toks),
                                 max_len=16)
    _close(tl, jl)
    for i in range(3):
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(
            np.int32)
        pos = np.full((2,), 9 + i, np.int32)
        jl, jcache = jdecode(jp, jnp.asarray(nxt), jnp.asarray(pos), jcache)
        tl, tcache = tmodels.decode_step(model, tc, torch.from_numpy(nxt),
                                         torch.from_numpy(pos), tcache)
        _close(tl, jl)
    assert LAUNCHES.count == before       # CPU: the plain version
