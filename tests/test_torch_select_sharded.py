"""The sharded selection phase of the PyTorch port
(``search/select_sharded.py``) against the JAX package's
(``search/select_sharded.py``) and against the port's single-device
``select_programs``.

The merge functions run in this process over S row blocks (S = 2, 4, 8);
the JAX side shards over the first S of the conftest's 8 CPU devices.
The whole phase runs in 2 and 4 gloo ranks spawned as subprocesses that
import no jax (``tests/_torch_mh_worker.py``), once per rank count for
every variant. With injected dropout bits (the JAX side's fused head in
interpret mode, the port's plain version of the kernel) the selected
indices, their validity and the new remaining mask are equal exactly;
the float scores within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from _torch_mh import run_ranks
from _torch_parity import np_predictor_params, to_jax, to_torch
from vae_extent_search_tpu.search import select as js
from vae_extent_search_tpu.search import select_sharded as jss
from vae_extent_search_tpu_torch.search import select as ts
from vae_extent_search_tpu_torch.search import select_sharded as tss

TOL = 1e-5
N, D, HID, LAT, HP, T = 512, 17, 128, 16, 128, 4
SEL = dict(num_select=32, T_mc=T, topk_factor=5, grad_num=2, max_centers=256)
N_MEAS = 64


def _mesh(s):
    return Mesh(np.asarray(jax.devices()[:s]), ("data",))


def _put(x, mesh, spec):
    return jax.device_put(x, NamedSharding(mesh, spec))


# ---------------------------------------------------------------------------
# the merges, in process
# ---------------------------------------------------------------------------


def _tied_scores(seed, n):
    rng = np.random.default_rng(seed)
    # bf16 rounding makes duplicate values: ties the merge must break
    # toward the lower global index
    s = jnp.asarray(rng.standard_normal(n), jnp.bfloat16).astype(jnp.float32)
    return np.array(s), rng.random(n) < 0.7


@pytest.mark.parametrize("k", [37, 200, 600])
@pytest.mark.parametrize("s", [2, 4, 8])
def test_merge_top_k_matches_jax(s, k):
    n = 512
    scores, mask = _tied_scores(s, n)
    mesh = _mesh(s)
    ij, vj = jss.masked_top_k_sharded(_put(scores, mesh, P("data")),
                                      _put(mask, mesh, P("data")), k, mesh,
                                      "data")
    n_loc = n // s
    parts = [tss.local_top_k(torch.as_tensor(scores[r * n_loc:][:n_loc]),
                             torch.as_tensor(mask[r * n_loc:][:n_loc]), k,
                             r * n_loc) for r in range(s)]
    it, vt = tss.merge_top_k([p[0] for p in parts], [p[1] for p in parts], k)
    ij, vj = np.asarray(ij), np.asarray(vj)
    assert np.array_equal(vt.numpy(), vj)
    assert np.array_equal(it.numpy()[vt.numpy()], ij[vj])
    # and the single-device masked_top_k of the port
    i1, v1 = ts.masked_top_k(torch.as_tensor(scores), torch.as_tensor(mask),
                             k)
    assert np.array_equal(v1.numpy(), vt.numpy())
    assert np.array_equal(i1.numpy()[v1.numpy()], it.numpy()[vt.numpy()])


@pytest.mark.parametrize("s", [2, 4, 8])
def test_merge_gathered_rows_matches_jax(s):
    n = 512
    rng = np.random.default_rng(10 + s)
    z = rng.standard_normal((n, 16)).astype(np.float32)
    idx = np.asarray([0, 5, 511, 63, 64, 200, 5], np.int64)
    mesh = _mesh(s)
    gj = np.asarray(jss.gather_rows_sharded(
        _put(z, mesh, P("data", None)), jnp.asarray(idx, jnp.int32), mesh,
        "data"))
    n_loc = n // s
    gt = tss.merge_gathered_rows(
        [tss.local_rows(torch.as_tensor(z[r * n_loc:][:n_loc]),
                        torch.as_tensor(idx), r * n_loc) for r in range(s)])
    assert np.array_equal(gt.numpy(), gj)
    assert np.array_equal(gt.numpy(), z[idx])


@pytest.mark.parametrize("max_rows", [16, 64, 300])
@pytest.mark.parametrize("s", [2, 4, 8])
def test_merge_masked_rows_matches_jax(s, max_rows):
    n = 512
    rng = np.random.default_rng(20 + s)
    z = rng.standard_normal((n, 16)).astype(np.float32)
    cmask = rng.random(n) < 0.1
    mesh = _mesh(s)
    rj, vj = jss.gather_masked_rows_sharded(
        _put(z, mesh, P("data", None)), _put(cmask, mesh, P("data")),
        max_rows, mesh, "data")
    rj, vj = np.asarray(rj), np.asarray(vj)
    n_loc = n // s
    parts = [tss.local_masked_rows(torch.as_tensor(z[r * n_loc:][:n_loc]),
                                   torch.as_tensor(cmask[r * n_loc:][:n_loc]),
                                   max_rows, r * n_loc) for r in range(s)]
    rt, vt = tss.merge_masked_rows([p[0] for p in parts],
                                   [p[1] for p in parts], max_rows)
    rt, vt = rt.numpy(), vt.numpy()
    assert rt.shape == (max_rows, 16)
    m = min(len(vj), max_rows)
    assert np.array_equal(vt[:m], vj[:m]) and not vt[m:].any()
    assert np.array_equal(rt[:m][vt[:m]], rj[:m][vj[:m]])
    # the first max_rows masked rows in index order
    ref = np.flatnonzero(cmask)[:max_rows]
    assert np.array_equal(vt, np.arange(max_rows) < len(ref))
    assert np.array_equal(rt[vt], z[ref])


# ---------------------------------------------------------------------------
# the whole phase in gloo ranks
# ---------------------------------------------------------------------------

# (name, SelectionConfig fields, injected bits, gate, center buffer,
# compared with the JAX phase)
VARIANTS = [
    ("fused", dict(rand_num=0), True, False, True, True),
    ("fused_gate", dict(rand_num=0), True, True, True, True),
    ("fused_mask_centers", dict(rand_num=0), True, False, False, True),
    ("fused_gate_mask_centers", dict(rand_num=0), True, True, False, True),
    ("fused_random", dict(rand_num=4), True, True, False, False),
    ("unfused", dict(rand_num=4, dropout_rate=0.0), False, False, True,
     False),
    ("unfused_gate_mask_centers", dict(rand_num=4, dropout_rate=0.0), False,
     True, False, False),
    ("unfused_mc", dict(rand_num=4), False, True, True, False),
    # bfloat16: each rank hands the fused head its float32 rows, which
    # the head rounds as it reads them, and rounds the gathered rows it
    # re-encodes for k-center, as the single-device phase does
    ("fused_bf16", dict(rand_num=0, compute_dtype="bfloat16"), True, False,
     True, False),
    ("fused_bf16_mask_centers", dict(rand_num=0, compute_dtype="bfloat16"),
     True, True, False, False),
]


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    params = np_predictor_params(rng, D, HID, LAT, HP)
    x = rng.standard_normal((N, D)).astype(np.float32)
    x[1::4] = x[0::4]       # duplicate rows: exact ties in every top-k
    bits = rng.integers(0, 2 ** 32, (T, N, HP), dtype=np.uint32)
    meas = rng.choice(N, N_MEAS, replace=False)
    used = np.zeros(N, bool)
    used[meas] = True
    cidx = np.zeros(SEL["max_centers"], np.int64)
    cidx[:N_MEAS] = meas
    cval = np.arange(SEL["max_centers"]) < N_MEAS
    return dict(params=params, X=x, bits=bits, used=used, center_idx=cidx,
                center_valid=cval)


@pytest.fixture(scope="module")
def single(inputs):
    """The port's single-device phase for every variant."""
    out = []
    for _, cfg, bits, gate, buf, _ in VARIANTS:
        kw = {}
        if buf:
            kw = dict(center_idx=torch.as_tensor(inputs["center_idx"]),
                      center_valid=torch.as_tensor(inputs["center_valid"]))
        with torch.no_grad():
            sel, val, rem, aux = ts.select_programs(
                to_torch(inputs["params"]), torch.as_tensor(inputs["X"]),
                torch.as_tensor(inputs["used"]),
                torch.as_tensor(~inputs["used"]),
                torch.Generator().manual_seed(3),
                ts.SelectionConfig(**SEL, **cfg),
                gate_uncertainty_to_remaining=gate,
                mask_bits=torch.as_tensor(inputs["bits"]) if bits else None,
                **kw)
        out.append({"sel": sel.numpy(), "valid": val.numpy(),
                    "rem": rem.numpy(),
                    **{k: v.numpy() for k, v in aux.items()}})
    return out


@pytest.fixture(scope="module")
def sharded(inputs, tmp_path_factory):
    """{ranks: every rank's results for every variant}."""
    inp = dict(inputs, variants=[
        dict(cfg=dict(SEL, **cfg), bits=bits, gate=gate, centers=buf,
             seed=3) for _, cfg, bits, gate, buf, _ in VARIANTS])
    d = str(tmp_path_factory.mktemp("select_sharded"))
    return {w: run_ranks("select", inp, w, d) for w in (2, 4)}


def _jax_phase(inputs, s, cfg, gate, buf):
    mesh = _mesh(s)
    kw = {}
    if buf:
        kw = dict(center_idx=jnp.asarray(inputs["center_idx"], jnp.int32),
                  center_valid=jnp.asarray(inputs["center_valid"]))
    sel, val, rem, aux = js.select_programs(
        to_jax(inputs["params"]), _put(inputs["X"], mesh, P("data", None)),
        _put(inputs["used"], mesh, P("data")),
        _put(~inputs["used"], mesh, P("data")), jax.random.PRNGKey(0),
        js.SelectionConfig(fused_interpret=True, **SEL, **cfg),
        gate_uncertainty_to_remaining=gate,
        mask_bits=_put(inputs["bits"], mesh, P(None, "data", None)), **kw)
    return {"sel": np.asarray(sel), "valid": np.asarray(val),
            "rem": np.asarray(rem),
            **{k: np.asarray(v) for k, v in aux.items()}}


def _assert_same_picks(a, b):
    assert np.array_equal(a["valid"], b["valid"])
    assert np.array_equal(a["sel"][a["valid"]], b["sel"][b["valid"]])
    assert np.array_equal(a["rem"], b["rem"])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("variant", range(len(VARIANTS)),
                         ids=[v[0] for v in VARIANTS])
def test_sharded_phase_matches_single_device(inputs, sharded, single,
                                             variant, world):
    """Every rank picks exactly what the single-device phase picks (with
    the MC variance of the unfused path from each rank's own stream only
    at dropout rate 0, where it draws nothing), with the same scores."""
    name, cfg, _, _, _, _ = VARIANTS[variant]
    ranks = [r[variant] for r in sharded[world]]
    for r in ranks[1:]:
        _assert_same_picks(ranks[0], r)
    got = ranks[0]
    assert got["valid"].sum() == SEL["num_select"]
    sel = got["sel"][got["valid"]]
    assert len(set(sel.tolist())) == len(sel)
    assert not inputs["used"][sel].any()
    assert int(got["rem"].sum()) == N - N_MEAS - len(sel)
    if name == "unfused_mc":
        # each rank draws its own MC masks: fresh, distinct picks, not
        # the single-device ones
        return
    _assert_same_picks(got, single[variant])
    for k in ("cost_pred", "mc_var", "grad_norm"):
        np.testing.assert_allclose(got[k], single[variant][k], atol=TOL)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize(
    "variant", [i for i, v in enumerate(VARIANTS) if v[5]],
    ids=[v[0] for v in VARIANTS if v[5]])
def test_sharded_phase_matches_jax_sharded(inputs, sharded, variant, world):
    """The port's sharded phase picks exactly what the JAX sharded phase
    picks over a mesh of as many devices, with the same injected bits."""
    _, cfg, _, gate, buf, _ = VARIANTS[variant]
    want = _jax_phase(inputs, world, cfg, gate, buf)
    got = sharded[world][0][variant]
    _assert_same_picks(got, want)
    for k in ("cost_pred", "mc_var", "grad_norm"):
        np.testing.assert_allclose(got[k], want[k], atol=TOL)
