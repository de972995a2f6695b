"""The port's K16 (``ops/cuda/performer.performer_rest``; on the CPU: its
plain twin) against the JAX whole-TokenPerformer kernel ``performer_rest``
(``ops/pallas/performer.py``) in interpret mode, set up as the JAX package's
own test sets it (tests/test_pallas_kernels.py:438-470), and the port's
``_performer_dispatch``."""

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgevisiontransformer_tpu.models.t2t_vit import _performer_rest as jax_chain
from edgevisiontransformer_tpu.ops.pallas.performer import performer_rest as jax_k16
from edgevisiontransformer_tpu_torch.config import ViTConfig
from edgevisiontransformer_tpu_torch.models import t2t_vit as tt2t
from edgevisiontransformer_tpu_torch.ops.cuda import performer as tperf

torch.set_num_threads(1)

TS, M = 64, 32
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# fp32: the same function in fp32 on both sides, summed in other orders
FP32_REL = 1e-5
# bf16: the JAX package's own bound for K16 against the eager chain
BF16_REL = 0.02


@functools.lru_cache(maxsize=None)
def _setup(n: int, dtype: str):
    r = np.random.RandomState(0)
    p = {"attn_output": {"kernel": r.randn(TS, TS) * 0.1, "bias": r.randn(TS) * 0.1},
         "norm2_scale": 1 + r.randn(TS) * 0.1, "norm2_bias": r.randn(TS) * 0.1,
         "mlp_fc1_kernel": r.randn(TS, TS) * 0.1, "mlp_fc1_bias": r.randn(TS) * 0.1,
         "mlp_fc2_kernel": r.randn(TS, TS) * 0.1, "mlp_fc2_bias": r.randn(TS) * 0.1}
    p = {k: ({kk: vv.astype(np.float32) for kk, vv in v.items()} if isinstance(v, dict)
             else v.astype(np.float32)) for k, v in p.items()}
    w = (r.randn(M, TS) * 0.3).astype(np.float32)
    x = (r.randn(2, n, 3 * TS) * 0.5).astype(np.float32)
    jd, td = DTYPES[dtype]
    jp = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict)
              else jnp.asarray(v)) for k, v in p.items()}
    tp = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict)
              else torch.from_numpy(v)) for k, v in p.items()}
    return jp, jnp.asarray(w), jnp.asarray(x).astype(jd), tp, torch.from_numpy(w), \
        torch.from_numpy(x).to(td)


def _rel(got, ref) -> float:
    ref = ref.float().numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref, np.float32)
    got = got.float().numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("approx", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [784, 50])
def test_twin_matches_jax_k16(n, dtype, approx):
    """n = 784 is stage 2's token count; 50 leaves the TPU kernel padded rows,
    which must stay out of kp_sum and kptv."""
    jp, jw, jx, tp, tw, tx = _setup(n, dtype)
    ref = jax_k16(jx, jp, jw, eps_ln=1e-5, approx_gelu=approx)
    tperf.reset_launches()
    got = tperf.performer_rest(tx, tp, tw, eps_ln=1e-5, approx_gelu=approx)
    assert sum(tperf.LAUNCHES.values()) == 0  # a CPU tensor takes the twin
    torch.testing.assert_close(got, tperf.performer_rest_plain(tx, tp, tw, eps_ln=1e-5,
                                                               approx_gelu=approx),
                               rtol=0, atol=0)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (2, n, TS)
    assert _rel(got, ref) <= (FP32_REL if dtype == "float32" else BF16_REL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_routes_cpu_to_the_eager_chain_and_plain_to_the_twin(dtype):
    """On a CPU tensor ``_performer_dispatch`` is the eager chain the JAX
    package dispatches to (bit for bit the port's ``_performer_rest``, and
    close to JAX's), with ``plain`` K16's twin.  The two forms are not the
    same function: K16 divides by ``max(d, 1e-8)`` where the chain divides
    by ``d + 1e-8`` (1e-4 relative where ``d`` is small) and runs
    ``attn_output`` on bf16 weights; they agree within JAX's own bound for
    K16 against the chain."""
    jp, jw, jx, tp, tw, tx = _setup(784, dtype)
    cfg = ViTConfig(dtype=DTYPES[dtype][1], gelu_approx=True)
    jcfg = types.SimpleNamespace(dtype=DTYPES[dtype][0], gelu_approx=True)

    chain = tt2t._performer_dispatch(tx, tp, tw, cfg)
    torch.testing.assert_close(chain, tt2t._performer_rest(tx, tp, tw, cfg), rtol=0, atol=0)
    twin = tt2t._performer_dispatch(tx, tp, tw, cfg, plain=True)
    torch.testing.assert_close(twin, tperf.performer_rest_plain(tx, tp, tw, eps_ln=1e-5,
                                                                approx_gelu=True),
                               rtol=0, atol=0)
    ref = jax_chain(jx, jp, {"w": jw}, jcfg, TS)
    bound = FP32_REL if dtype == "float32" else BF16_REL
    assert _rel(chain, ref) <= bound
    assert _rel(twin, chain) <= BF16_REL


def test_wrapper_refuses_mixed_devices():
    _, _, _, tp, tw, tx = _setup(50, "float32")
    with pytest.raises(ValueError, match="CPU or all on one"):
        tperf.performer_rest(tx.to("meta"), tp, tw, eps_ln=1e-5, approx_gelu=True)
