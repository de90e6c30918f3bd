"""Card-only checks at deployment widths: the Triton group-by kernel
compiled for the GPU against a Python-int oracle and the XLA one-hot
path (2^22 rows, G up to 65,536), and the XLA scan sweep on the GPU
against the same sweep on the host CPU backend (1,024 packs, plane
widths 1..64). Integer results must match bit for bit. Marked `gpu`;
they skip without a GPU and run in chip_smoke.py's kernel phase
(python chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run through chip_smoke.py)")


@pytest.mark.parametrize("width", [1, 10, 20, 41, 64])
def test_scan_sweep_bit_exact(gpu, width):
    from knoxdb_tpu.testing import gpu_bench as GBN
    planes, mins = GBN.random_planes(width, width)
    valid = jnp.full((GBN.P_PACKS, GBN.W_WORDS), 0xFFFFFFFF, jnp.uint32)
    valid = valid.at[-1, -7:].set(0)
    lo, hi = GBN.query_range(width)
    args = (planes, mins, valid, jnp.uint64(lo), jnp.uint64(hi))
    f = jax.jit(GBN.xla_scan, static_argnums=5)
    got = f(*args, width)
    cpu = jax.devices("cpu")[0]
    want = f(*jax.device_put(args, cpu), width)
    for name, g, w in zip(("mask", "pcnt", "cnt", "min", "max"), got,
                          want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=f"w={width} {name}")


@pytest.mark.parametrize("G", [1000, 8192, 65536])
def test_group_xla_exact(gpu, G):
    from knoxdb_tpu.exec import groupby as GB
    from knoxdb_tpu.testing import gpu_bench as GBN
    gids, mask, lo, hi = GBN.group_inputs(G, G, P=64)
    counts, chunks, _, _ = jax.jit(GBN.group_xla, static_argnums=4)(
        gids, mask, lo, hi, G)
    cnt, sums = GBN.group_oracle(gids, lo, hi, G)
    np.testing.assert_array_equal(np.asarray(counts), cnt)
    assert list(GB.mxu_chunk_sums(chunks)) == list(sums)


@pytest.mark.parametrize("G", [20, 1000, 8192, 65536])
def test_group_kernel_exact(gpu, G):
    from knoxdb_tpu.exec import groupby as GB
    from knoxdb_tpu.testing import gpu_bench as GBN
    gids, mask, lo, hi = GBN.group_inputs(G + 1, G, P=64)
    counts, chunks, _, _ = jax.jit(GBN.group_kernel, static_argnums=4)(
        gids, mask, lo, hi, G)
    cnt, sums = GBN.group_oracle(gids, lo, hi, G)
    np.testing.assert_array_equal(np.asarray(counts), cnt)
    assert list(GB.mxu_chunk_sums(chunks)) == list(sums)
