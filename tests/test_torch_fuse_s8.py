"""The int8 Siamese fusion's plain version
(``fabric_tpu_torch.ops.fuse_s8.siamese_fuse_s8_reference``, which the
wrapper computes on the CPU and the kernel ``csrc/siamese_s8.cu`` is held
to on the card) against ``fabric_tpu``'s int8 forward on the same seeded
numpy int8 inputs: its ``fuse_q`` and ``f5`` expressions
(``fabric_tpu/infer/quant.py:336-352``, evaluated with ``jnp``) and its
int8 max-pool (``make_helpers(...).pool``, ``lax.reduce_window``).  Both
are exact integer products scaled once in float32, so they must be
bit-equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fabric_tpu.infer import quant as jq

from fabric_tpu_torch.ops import fuse_s8

# (n, H, W, C): small levels, odd H and W, 1x1 images
LEVELS = [(2, 8, 8, 16), (1, 7, 9, 32), (3, 5, 4, 16), (2, 1, 1, 16),
          (1, 6, 11, 48)]
# (sk, sf): a level's scale and its fused skip's, m = sk * sk / sf.  A
# calibrated-looking pair; m = 1/64 (every product a multiple of 1/64:
# ties at .5, codes clipped at 127 above 8128); m = 0.5 (odd products
# tie); a large m that clips most codes
SCALES = [(3.1 / 127, 5.3 / 127), (1.0, 64.0), (1.0, 2.0), (0.05, 3e-4)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _codes(seed, n, h, w, c):
    """(2n, H, W, C) int8 codes over the whole int8 range, both dates."""
    rng = np.random.RandomState(seed)
    return rng.randint(-128, 128, (2 * n, h, w, c)).astype(np.int8)


def _jax_fuse_q(a, n, sk, sf):
    """fabric_tpu/infer/quant.py:336-341, as written there."""
    prod = jnp.maximum(a[n:].astype(jnp.int32)
                       * a[:n].astype(jnp.int32), 0)
    return jnp.clip(jnp.round(
        prod.astype(jnp.float32) * (sk * sk / sf)),
        0, 127).astype(jnp.int8)


def _jax_f5(x5, n, s5, dtype):
    """fabric_tpu/infer/quant.py:349-351, as written there."""
    return (jnp.maximum(x5[n:].astype(jnp.int32)
                        * x5[:n].astype(jnp.int32), 0)
            .astype(jnp.float32) * (s5 * s5)).astype(dtype)


_POOL = jq.make_helpers({}, None, None, sites={}).pool


@pytest.mark.parametrize("sk,sf", SCALES)
@pytest.mark.parametrize("n,h,w,c", LEVELS)
def test_int8_fusion_and_pool_match_fabric_tpu(n, h, w, c, sk, sf):
    a = _codes(n * h * w + c, n, h, w, c)
    want_f = np.asarray(_jax_fuse_q(jnp.asarray(a), n, sk, sf))
    want_p = np.asarray(_POOL(jnp.asarray(a)))
    ta = torch.from_numpy(a)
    f, p = fuse_s8.siamese_fuse_s8_reference(ta, sk * sk / sf)
    assert f.dtype == torch.int8 and f.shape == (n, h, w, c)
    assert p.dtype == torch.int8 and p.shape == (2 * n, h // 2, w // 2, c)
    np.testing.assert_array_equal(f.numpy(), want_f)
    np.testing.assert_array_equal(p.numpy(), want_p)
    f2, p2 = fuse_s8.siamese_fuse_s8(ta, sk * sk / sf)  # the CPU wrapper
    assert torch.equal(f2, f) and torch.equal(p2, p)
    if (sk, sf) == (1.0, 64.0) and a.size >= 256:
        # the data reach the cases that rounding and clipping decide
        prod = np.maximum(a[n:].astype(np.int32) * a[:n], 0)
        assert ((prod % 64) == 32).any() and (want_f == 127).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,w,c", LEVELS[:3])
def test_f5_matches_fabric_tpu(n, h, w, c, dtype):
    a = _codes(7 + n * h * w * c, n, h, w, c)
    s5 = 4.7 / 127
    want = np.asarray(_jax_f5(jnp.asarray(a), n, s5, getattr(jnp, dtype)),
                      np.float32)
    f, p = fuse_s8.siamese_fuse_s8(torch.from_numpy(a), s5 * s5,
                                   getattr(torch, dtype), pool=False)
    assert p is None and f.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(f.float().numpy(), want)
