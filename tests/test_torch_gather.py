"""K3, the column gather: ``fourdgs_tpu_torch.ops.gather`` against the JAX
kernel ``scripts/exp_gather.py::gk`` under the Pallas interpreter and
against ``jnp.take``, at P = 512 and at a P that is no multiple of 32 (the
card's staging pass masks its last run of columns); and the two passes'
hooks (staging, gather from a [P, 16] table) on the CPU. A gather moves
values: the tolerance is 0."""

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu_torch.ops import gather

P, K, BLK = 512, 4096, 2048


def _inputs(seed=0, P=P):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((16, P), dtype=np.float32)
    idx = rng.integers(0, P, K, dtype=np.int32)
    idx[:64] = 7 % P        # a run of repeats
    idx[100:300] = 0        # the render's padding id
    idx[-5:] = P - 1        # the last column
    return table, idx


def _jax_gk(idx, table):
    """``scripts/exp_gather.py:88-102`` (the kernel and its call, verbatim
    but for the sizes, taken from the inputs, and ``interpret=True``; the
    closure cannot be imported). K must be a multiple of BLK."""
    P, K = table.shape[1], idx.shape[0]
    assert K % BLK == 0

    def gk(idx_ref, tbl_ref, out_ref):
        ids = idx_ref[0, :]                       # [BLK] int32
        out_ref[:, :] = jnp.take(tbl_ref[:, :], ids, axis=1)

    gather_p = pl.pallas_call(
        gk,
        grid=(K // BLK,),
        in_specs=[
            pl.BlockSpec((1, BLK), lambda t: (0, t)),
            pl.BlockSpec((16, P), lambda t: (0, 0)),
        ],
        out_specs=pl.BlockSpec((16, BLK), lambda t: (0, t)),
        out_shape=jax.ShapeDtypeStruct((16, K), jnp.float32),
        interpret=True,
    )
    return np.asarray(jax.jit(lambda i, t: gather_p(i.reshape(1, -1), t))(
        jnp.asarray(idx), jnp.asarray(table)))


@pytest.mark.parametrize("p", [P, 2049])
def test_gather_cols_matches_jax_kernel(p):
    table, idx = _inputs(P=p)
    before = gather.gather_cols.launches
    got = gather.gather_cols(torch.from_numpy(table), torch.from_numpy(idx)).numpy()
    assert gather.gather_cols.launches == before      # the plain version ran
    np.testing.assert_array_equal(got, _jax_gk(idx, table))
    np.testing.assert_array_equal(got, np.asarray(jnp.take(table, idx, axis=1)))
    assert got.shape == (16, K) and got.dtype == np.float32


@pytest.mark.parametrize("seed", [1, 2])
def test_plain_is_index_select(seed):
    table, idx = _inputs(seed)
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    np.testing.assert_array_equal(gather.gather_cols_plain(t, i).numpy(), table[:, idx])
    assert torch.equal(gather.gather_cols(t, i), torch.index_select(t, 1, i))


def test_wrapper_rejects_bad_inputs():
    table, idx = (torch.from_numpy(x) for x in _inputs())
    bad = [
        (table.double(), idx),                     # dtype
        (table.to(torch.bfloat16), idx),
        (table, idx.long()),
        (table[:8], idx),                          # not 16 rows
        (table, idx.reshape(1, -1)),               # [1, K]: pass [K]
        (table.T.contiguous().T, idx),             # not contiguous
        (table, idx[::2]),
        (table, idx.to("meta")),                   # two devices
    ]
    for t, i in bad:
        with pytest.raises(ValueError):
            gather.gather_cols(t, i)


@pytest.mark.parametrize("p", [1, 17, 2049])
def test_pass_hooks_compose_to_the_gather(p):
    """The staging hook writes the table Gaussian-major; the gather hook on
    that [P, 16] table is the render path's ``index_select(0).T``, and the
    two passes give :func:`gather_cols` (the plain versions, on the CPU)."""
    table, idx = _inputs(seed=3, P=p)
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    before = gather.gather_cols.launches
    rows = gather._stage_rows(t)
    assert rows.shape == (p, 16) and rows.is_contiguous()
    np.testing.assert_array_equal(rows.numpy(), table.T)
    got = gather._gather_rows(rows, i)
    assert got.is_contiguous()
    assert torch.equal(got, rows.index_select(0, i).T)
    assert torch.equal(got, gather.gather_cols(t, i))
    assert gather.gather_cols.launches == before


def test_pass_hooks_reject_bad_inputs():
    table, idx = (torch.from_numpy(x) for x in _inputs())
    with pytest.raises(ValueError):
        gather._stage_rows(table.T.contiguous())           # [P, 16]: pass [16, P]
    with pytest.raises(ValueError):
        gather._stage_rows(table[:, ::2])                  # not contiguous
    with pytest.raises(ValueError):
        gather._gather_rows(table, idx)                    # [16, P]: pass [P, 16]
    with pytest.raises(ValueError):
        gather._gather_rows(table.T.contiguous(), idx.long())
