"""The port's ragged segment sum (``ops/segment_sum.py``) against the JAX
package: ``jax.ops.segment_sum`` and the Pallas kernel in interpret mode,
forward and gradient, on inputs drawn with numpy from a seed. On the CPU
the wrapper runs its plain versions; the CUDA kernels are held against
those same plain versions by the ``cuda``-marked tests and ``chip_smoke.py``.

Tolerances: the plain forward adds the same float32 numbers as the JAX
scatter, possibly in another order: 1e-6 of max |out| (segments of <= 32
rows). The backward is a copy: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rel_err
from vae_extent_search_tpu.ops import segment_sum_pallas as jss
from vae_extent_search_tpu_torch.ops import segment_sum as tss

TOL = 1e-6


def ragged(seed, n_seg, H, lo=0, hi=9, pad_rows=0):
    """(features [R + pad_rows, H], ids with n_seg for the padding rows)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(lo, hi, size=n_seg)
    ids = np.concatenate([np.repeat(np.arange(n_seg), counts),
                          np.full(pad_rows, n_seg)]).astype(np.int32)
    feats = rng.normal(size=(len(ids), H)).astype(np.float32)
    return feats, ids


CASES = {
    "h128": dict(n_seg=24, H=128, lo=1),
    "h164_odd_rows": dict(n_seg=37, H=164, lo=1, hi=12),
    "padding_rows": dict(n_seg=16, H=40, pad_rows=23),
    "empty_segments": dict(n_seg=40, H=8, lo=0, hi=3),
    "one_segment": dict(n_seg=1, H=5, lo=30, hi=31),
}


@pytest.mark.parametrize("case", CASES)
def test_plain_forward_matches_jax_segment_sum(case):
    kw = CASES[case]
    feats, ids = ragged(1, **kw)
    n_seg = kw["n_seg"]
    ref = jax.ops.segment_sum(jnp.asarray(feats), jnp.asarray(ids),
                              num_segments=n_seg + 1)[:n_seg]
    got = tss.segment_sum_plain(torch.as_tensor(feats), torch.as_tensor(ids),
                                n_seg)
    assert got.shape == (n_seg, kw["H"]) and got.dtype == torch.float32
    assert rel_err(got.numpy(), ref) < TOL
    # through the wrapper, with the offsets the batch loaders carry and
    # with offsets found from the ids
    offs = torch.as_tensor(tss.segment_ids_to_offsets(ids, n_seg))
    for o in (offs, None):
        via = tss.segment_sum_rows(torch.as_tensor(feats),
                                   torch.as_tensor(ids), n_seg, o)
        assert torch.equal(via, got)


@pytest.mark.parametrize("H", [128, 164])
def test_plain_forward_matches_pallas_interpret(H):
    """As tests/test_models.py runs the TPU kernel on the CPU: padded by
    pad_for_pallas, interpret=True."""
    S, MAXR = 24, 16
    feats, ids = ragged(2, S, H, lo=1, hi=9)
    offs = jss.segment_ids_to_offsets(ids, S)
    fp, fo, S2 = jss.pad_for_pallas(feats, offs, MAXR)
    ref = jss.segment_sum_pallas(jnp.asarray(fp), jnp.asarray(fo), S2, MAXR,
                                 interpret=True)[:S]
    got = tss.segment_sum(torch.as_tensor(feats), torch.as_tensor(offs))
    assert rel_err(got.numpy(), ref) < TOL


@pytest.mark.parametrize("case", CASES)
def test_backward_matches_jax_grad(case):
    kw = CASES[case]
    feats, ids = ragged(3, **kw)
    n_seg = kw["n_seg"]
    w = np.random.default_rng(4).normal(size=(n_seg, kw["H"])).astype(
        np.float32)

    def loss(x):
        s = jax.ops.segment_sum(x, jnp.asarray(ids),
                                num_segments=n_seg + 1)[:n_seg]
        return jnp.sum(s * jnp.asarray(w))

    ref = jax.grad(loss)(jnp.asarray(feats))
    x = torch.as_tensor(feats).requires_grad_(True)
    offs = torch.as_tensor(tss.segment_ids_to_offsets(ids, n_seg))
    (tss.segment_sum(x, offs) * torch.as_tensor(w)).sum().backward()
    assert np.array_equal(x.grad.numpy(), np.asarray(ref))
    plain = tss.segment_sum_grad_plain(torch.as_tensor(w),
                                       torch.as_tensor(ids), n_seg)
    assert torch.equal(plain, x.grad)


def test_empty_segments_at_start_middle_end_and_padding():
    H = 6
    counts = np.array([0, 0, 3, 0, 2, 1, 0, 0])
    n_seg = len(counts)
    ids = np.concatenate([np.repeat(np.arange(n_seg), counts),
                          np.full(4, n_seg)]).astype(np.int32)
    feats = np.arange(len(ids) * H, dtype=np.float32).reshape(-1, H)
    offs = tss.segment_ids_to_offsets(ids, n_seg)
    assert offs.tolist() == [0, 0, 0, 3, 3, 5, 6, 6, 6]
    x = torch.as_tensor(feats).requires_grad_(True)
    out = tss.segment_sum(x, torch.as_tensor(offs))
    want = np.stack([feats[ids == s].sum(0) for s in range(n_seg)])
    assert np.array_equal(out.detach().numpy(), want)
    assert not out[[0, 1, 3, 6, 7]].any()
    out.sum().backward()
    assert np.array_equal(x.grad.numpy(),
                          np.repeat((ids < n_seg)[:, None], H, 1).astype(
                              np.float32))


@pytest.mark.parametrize("case", CASES)
def test_segment_ids_to_offsets_equal(case):
    kw = CASES[case]
    _, ids = ragged(5, **kw)
    n_seg = kw["n_seg"]
    ours = tss.segment_ids_to_offsets(ids, n_seg)
    assert ours.dtype == np.int32
    assert np.array_equal(ours, jss.segment_ids_to_offsets(ids, n_seg))
    t_ids = torch.as_tensor(ids)
    assert np.array_equal(tss.ids_to_offsets_device(t_ids, n_seg).numpy(),
                          ours)
    back = tss.offsets_to_segment_ids(torch.as_tensor(ours), len(ids))
    assert np.array_equal(back.numpy(), ids)


def test_autograd_function_gradcheck_float64():
    feats, ids = ragged(6, 9, 5, lo=0, hi=4, pad_rows=3)
    offs = torch.as_tensor(tss.segment_ids_to_offsets(ids, 9))
    x = torch.as_tensor(feats, dtype=torch.float64).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda t: tss.segment_sum(t, offs), (x,))


def test_bfloat16_storage_is_upcast():
    feats, ids = ragged(7, 12, 16, lo=1)
    offs = torch.as_tensor(tss.segment_ids_to_offsets(ids, 12))
    xb = torch.as_tensor(feats).to(torch.bfloat16)
    got = tss.segment_sum(xb, offs)
    assert got.dtype == torch.float32
    assert torch.equal(got, tss.segment_sum(xb.float(), offs))
    xb.requires_grad_(True)
    tss.segment_sum(xb, offs).sum().backward()
    assert xb.grad.dtype == torch.bfloat16 and bool((xb.grad == 1).all())


def test_rows_before_the_first_offset_add_nothing():
    feats = np.ones((10, 3), np.float32)
    offs = torch.as_tensor(np.array([2, 5, 8], np.int32))
    x = torch.as_tensor(feats).requires_grad_(True)
    out = tss.segment_sum(x, offs)
    assert out.tolist() == [[3.0] * 3, [3.0] * 3]
    out.sum().backward()
    assert x.grad[:, 0].tolist() == [0, 0, 1, 1, 1, 1, 1, 1, 0, 0]


def test_loaders_reject_ids_the_kernel_cannot_take():
    tss.check_contiguous(np.array([0, 0, 2, 2, 5, 5], np.int32), 5)
    with pytest.raises(ValueError, match="non-decreasing"):
        tss.check_contiguous(np.array([0, 1, 0], np.int32), 2)
    with pytest.raises(ValueError, match="non-decreasing"):
        tss.check_contiguous(np.array([3, 0, 1], np.int32), 3)
    with pytest.raises(ValueError, match="entries"):
        tss.segment_sum_rows(torch.zeros(3, 2), torch.zeros(3).int(), 2,
                             torch.zeros(2, dtype=torch.int32))


def test_launch_checks_and_counts():
    """What the CUDA path refuses is refused before any launch, and the CPU
    path never counts a launch."""
    x = torch.zeros(4, 3)
    offs = torch.as_tensor(np.array([0, 2, 4], np.int32))
    before = (tss.segment_sum.launches, tss.segment_sum.backward_launches)
    tss.segment_sum(x.requires_grad_(True), offs).sum().backward()
    assert (tss.segment_sum.launches,
            tss.segment_sum.backward_launches) == before
    for bad_x, bad_o in ((x.double(), offs), (x[0], offs), (x, offs.long()),
                         (x, offs[None])):
        with pytest.raises(ValueError):
            tss._check(bad_x.detach(), bad_o)
    with pytest.raises(ValueError, match="unsupported device"):
        tss.segment_sum(torch.zeros(2, 2, device="meta"), offs)
