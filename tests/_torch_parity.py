"""Shared inputs for the parity tests between the JAX package and its
PyTorch port: parameters and data are drawn with numpy from a seed and
handed to both packages as numpy arrays."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vae_extent_search_tpu_torch.convert import params_from_numpy, tree_map

# the tests run several pytest workers side by side: keep each worker's
# torch to two intra-op threads instead of one per core
torch.set_num_threads(2)


def np_dense(rng, in_dim, out_dim):
    bw = math.sqrt(1.0 / in_dim) * math.sqrt(3.0)
    bb = math.sqrt(1.0 / in_dim)
    return {"w": rng.uniform(-bw, bw, (in_dim, out_dim)).astype(np.float32),
            "b": rng.uniform(-bb, bb, (out_dim,)).astype(np.float32)}


def np_mlp(rng, dims):
    return [np_dense(rng, dims[i], dims[i + 1]) for i in range(len(dims) - 1)]


def np_predictor_params(rng, input_dim, hidden_dim, latent_dim,
                        predictor_hidden):
    return {
        "encoder": np_mlp(rng, [input_dim] + [hidden_dim] * 3),
        "fc_mu": np_dense(rng, hidden_dim, latent_dim),
        "fc_logvar": np_dense(rng, hidden_dim, latent_dim),
        "cost_predictor": np_mlp(
            rng, [latent_dim, predictor_hidden, predictor_hidden, 1]),
    }


def np_vae_params(rng, input_dim, latent_dim, hidden_dim):
    return {
        "encoder": np_mlp(rng, [input_dim] + [hidden_dim] * 3),
        "fc_mu": np_dense(rng, hidden_dim, latent_dim),
        "fc_logvar": np_dense(rng, hidden_dim, latent_dim),
        "decoder": np_mlp(rng, [latent_dim] + [hidden_dim] * 3 + [input_dim]),
    }


def np_segment_trunk(rng, in_dim, hidden_dim, latent_dim):
    return {
        "segment_encoder": np_mlp(rng, [in_dim, hidden_dim, hidden_dim]),
        "l0": np_mlp(rng, [hidden_dim, hidden_dim]),
        "l1": np_mlp(rng, [hidden_dim, hidden_dim]),
        "fc_mean": np_dense(rng, hidden_dim, latent_dim),
        "fc_logvar": np_dense(rng, hidden_dim, latent_dim),
    }


def np_segment_mlp_params(rng, in_dim, hidden_dim):
    return {
        "segment_encoder": np_mlp(rng, [in_dim, hidden_dim, hidden_dim]),
        "l0": np_mlp(rng, [hidden_dim, hidden_dim]),
        "l1": np_mlp(rng, [hidden_dim, hidden_dim]),
        "decoder": np_dense(rng, hidden_dim, 1),
    }


def np_segment_vae_params(rng, in_dim, hidden_dim, latent_dim):
    p = np_segment_trunk(rng, in_dim, hidden_dim, latent_dim)
    p["decoder"] = np_mlp(rng, [latent_dim] + [hidden_dim] * 3)
    return p


def np_segment_predictor_params(rng, in_dim, hidden_dim, latent_dim,
                                predictor_hidden):
    p = np_segment_trunk(rng, in_dim, hidden_dim, latent_dim)
    p["cost_predictor"] = np_mlp(
        rng, [latent_dim, predictor_hidden, predictor_hidden, 1])
    return p


def ragged_programs(rng, n, dim, lo=1, hi=8, scale=1.0):
    """n ragged [rows_i, dim] float32 feature arrays, lo <= rows_i < hi."""
    return [(rng.random((int(rng.integers(lo, hi)), dim)) * scale
             ).astype(np.float32) for _ in range(n)]


def to_jax(tree):
    return tree_map(jnp.asarray, tree)


def to_torch(tree):
    return params_from_numpy(tree, "cpu")


def rel_err(got, ref):
    """max |got - ref| / max |ref| (floored at 1e-12), both as float64."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-12))


def tree_rel_err(got, ref):
    """Largest per-leaf rel_err over two trees of the same structure."""
    g = jax.tree_util.tree_leaves(tree_map(
        lambda t: t.detach().numpy() if isinstance(t, torch.Tensor) else t,
        got))
    r = jax.tree_util.tree_leaves(tree_map(np.asarray, ref))
    assert len(g) == len(r)
    return max(rel_err(a, b) for a, b in zip(g, r))


def pin_jax_python_paths(mp):
    """Send the JAX package down its Python paths, the ones the port has:
    its GA without the native record-level engine, its per-store
    featuriser without the native batch (``mp``: a pytest MonkeyPatch)."""
    import functools

    from vae_extent_search_tpu.features import per_store as jps
    from vae_extent_search_tpu.search import cost_model as jcm
    from vae_extent_search_tpu.search import sketch as jsketch

    mp.setattr(jsketch.SketchPolicy, "_evolutionary_search_native_recs",
               lambda *a, **k: None)
    mp.setattr(jsketch.SketchPolicy, "_evolutionary_search_native",
               lambda *a, **k: None)
    states = functools.partial(jps.get_per_store_features_from_states,
                               use_native=False)
    for m in (jps, jcm):
        mp.setattr(m, "get_per_store_features_from_states", states)
    mp.setattr(jps, "get_per_store_features_from_measure_pairs",
               functools.partial(
                   jps.get_per_store_features_from_measure_pairs,
                   use_native=False))


def small_ga_population(mp, population):
    """Every SketchPolicy of both packages evolves ``population`` states
    per generation instead of the default 2,048 (the tuning loop's
    policies take no such option from their callers)."""
    from vae_extent_search_tpu.search import sketch as jsketch
    from vae_extent_search_tpu_torch.search import sketch as tsketch

    for cls in (jsketch.SketchPolicy, tsketch.SketchPolicy):
        def init(self, *a, _orig=cls.__init__, **kw):
            _orig(self, *a, **kw)
            self.params["evolutionary_search_population"] = population
        mp.setattr(cls, "__init__", init)


def pin_port_python_paths(mp):
    """Send the port down the same Python paths as ``pin_jax_python_paths``
    sends the JAX package: its GA without the native record-level engine,
    its per-store featurisers without the native batch. The tests that
    hold the two Python paths against each other pin both; the native
    paths are held against each other in ``tests/test_torch_native*.py``."""
    import functools

    from vae_extent_search_tpu_torch.cli import json_to_task_pkl as tjson
    from vae_extent_search_tpu_torch.cli import tune_vae as ttv
    from vae_extent_search_tpu_torch.features import per_store as tps
    from vae_extent_search_tpu_torch.search import cost_model as tcm
    from vae_extent_search_tpu_torch.search import sketch as tsketch

    mp.setattr(tsketch.SketchPolicy, "_evolutionary_search_native_recs",
               lambda *a, **k: None)
    mp.setattr(tsketch.SketchPolicy, "_evolutionary_search_native",
               lambda *a, **k: None)
    states = functools.partial(tps.get_per_store_features_from_states,
                               use_native=False)
    for m in (tps, tcm, ttv):
        mp.setattr(m, "get_per_store_features_from_states", states)
    for name, m in (("get_per_store_features_from_measure_pairs", (tps,)),
                    ("get_per_store_features_from_file", (tps, tjson)),
                    ("perstore_features_from_records", (tps,))):
        pinned = functools.partial(getattr(tps, name), use_native=False)
        for mod in m:
            mp.setattr(mod, name, pinned)


def jax_native_lib() -> bool:
    """Whether the JAX package's own loader gives its native library (it
    builds it with g++ at first use, as its tests do): the native-against-
    native comparisons run where it does."""
    from vae_extent_search_tpu.records import fast_parser as jfp

    try:
        jfp._load_lib()
    except Exception:
        return False
    return True
