"""The port's sketch GA on GPU targets against the JAX package's Python GA,
on the CPU: the CUDA-target sketches (structure "SSSRRSRS", the
shared-memory cache reads, the cross-thread reduction), the thread
binding and the initial population over five workloads (their
``make_states`` pools: tests/test_torch_sketch_gpu_states.py); the
shared caches' attach point; ``HardwareParams`` of every registered
platform and a non-default CPU platform's pool; the command lines that
now take ``--target cuda``. Host code over the same inputs: states,
records and costs are held equal, in the same order.

The JAX package runs its native record-level GA and per-store featuriser
where its library is built; the port has neither, so the JAX side is held
on its Python paths here, which its own tests hold equal to the native
ones.
"""

import functools
import random

import pytest

from vae_extent_search_tpu.features import per_store as jps
from vae_extent_search_tpu.records import serde as jserde
from vae_extent_search_tpu.records.task import HardwareParams as JHW
from vae_extent_search_tpu.records.task import SearchTask as JTask
from vae_extent_search_tpu.search import platforms as jplat
from vae_extent_search_tpu.search import sketch as jsketch
from vae_extent_search_tpu_torch.cli import dump_programs
from vae_extent_search_tpu_torch.records import make_workload_key
from vae_extent_search_tpu_torch.records import serde as tserde
from vae_extent_search_tpu_torch.records.task import HardwareParams as THW
from vae_extent_search_tpu_torch.records.task import SearchTask as TTask
from vae_extent_search_tpu_torch.search import sketch as tsketch
from vae_extent_search_tpu_torch.search.platforms import PLATFORMS
from _torch_parity import pin_port_python_paths

CONV56 = make_workload_key("conv2d_layer",
                           (1, 56, 56, 64, 64, 3, 3, [1, 1], [1, 1]))
WORKLOADS = {
    "conv2d_56": CONV56,
    "conv2d_14": make_workload_key("conv2d_layer",
                                   (1, 14, 14, 128, 128, 3, 3, [1, 1],
                                    [1, 1])),
    "matmul_512": make_workload_key("matmul_auto_scheduler_test",
                                    (512, 512, 512)),
    "min_nm": make_workload_key("min_nm_auto_scheduler_test", (4, 4096)),
    "softmax_nm": make_workload_key("softmax_nm_auto_scheduler_test",
                                    (64, 1024)),
}
# sketches per workload: the two reductions of a small space also take the
# cross-thread-reduction variant
N_SKETCHES = {"conv2d_56": 1, "conv2d_14": 1, "matmul_512": 1, "min_nm": 2,
              "softmax_nm": 2}
NAMES = sorted(WORKLOADS)


@pytest.fixture(scope="module")
def jax_python():
    """Hold the JAX package on its Python paths: its GA without the native
    engine, its per-store featuriser without the native batch."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jsketch.SketchPolicy, "_evolutionary_search_native_recs",
               lambda *a, **k: None)
    mp.setattr(jsketch.SketchPolicy, "_evolutionary_search_native",
               lambda *a, **k: None)
    mp.setattr(jps, "get_per_store_features_from_states",
               functools.partial(jps.get_per_store_features_from_states,
                                 use_native=False))
    pin_port_python_paths(mp)
    yield
    mp.undo()


def _tasks(name, target="cuda"):
    wk = WORKLOADS[name]
    return JTask(wk, target), TTask(wk, target)


def _recs(state):
    return [s.to_record() for s in state.transform_steps]


def _same(js, ts):
    assert [s.to_str() for s in ts] == [s.to_str() for s in js]
    assert [_recs(s) for s in ts] == [_recs(s) for s in js]


# ---------------------------------------------------------------------------
# sketches, thread binding, the initial population
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_generate_sketches_equal(name):
    jt, tt = _tasks(name)
    js, ts = jsketch.generate_sketches(jt), tsketch.generate_sketches(tt)
    _same(js, ts)
    assert len(ts) == N_SKETCHES[name]
    assert [s.tiled_stage_split_ids for s in ts] == \
        [s.tiled_stage_split_ids for s in js]
    # the GPU tiling: shared caches for the tiled stage's inputs, and a
    # "local" cache write where no elementwise consumer takes the fusion
    steps = [r for s in ts for r in _recs(s)]
    if name.startswith(("conv2d", "matmul")):
        assert sum(r[0] == "CHR" and r[2] == "shared" for r in steps) == 2
        assert any(r[0] == "CHW" and r[2] == "local" for r in steps) == \
            name.startswith("matmul")
    else:
        # the cross-thread variant binds the reduction to threadIdx.x
        assert any(r[0] == "AN" and r[3] == 6 for r in _recs(ts[-1]))


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", NAMES)
def test_init_thread_bind_equal(name, seed):
    """FillTileSize then ThreadBind on one random.Random per package, the
    same seed: the same bound states, and the same random stream after."""
    jt, tt = _tasks(name)
    jr, tr = random.Random(seed), random.Random(seed)
    for jsk, tsk in zip(jsketch.generate_sketches(jt),
                        tsketch.generate_sketches(tt)):
        for _ in range(3):
            js = jsketch.init_thread_bind(
                jsketch.init_fill_tile_size(jsk, jr), jt, jr)
            ts = tsketch.init_thread_bind(
                tsketch.init_fill_tile_size(tsk, tr), tt, tr)
            _same([js], [ts])
            annos = {it.annotation for st in ts.stages for it in st.iters}
            assert 6 in annos                  # threadIdx.x
            if name.startswith(("conv2d", "matmul")):
                assert {4, 5} <= annos         # blockIdx.x, vthread
    assert jr.random() == tr.random()


@pytest.mark.parametrize("name", NAMES)
def test_sample_initial_population_equal(name):
    jt, tt = _tasks(name)
    jp = jsketch.SketchPolicy(jt, seed=11).sample_initial_population(24)
    tp = tsketch.SketchPolicy(tt, seed=11).sample_initial_population(24)
    _same(jp, tp)
    assert tp and all(s.stages[-1].iters[0].range is not None for s in tp)
    pragmas = {r[3] for s in tp for r in _recs(s) if r[0] == "PR"}
    assert pragmas <= {f"auto_unroll_max_step${v}"
                       for v in tsketch.AUTO_UNROLL_CANDIDATES_GPU}


def test_gpu_cache_read_attach_outermost_reduce_tile():
    """As tests/test_pipeline.py::test_gpu_cache_read_attach_outermost_
    reduce_tile: the shared caches of the 56 x 56 conv2d attach at iter 14
    = leading space levels (3) x n_axes (4) + n_reduce (3) - 1 for
    structure "SSSRRSRS", the last reduce iterator of the outermost reduce
    tile."""
    task = TTask(CONV56, "cuda")
    cas = [r for s in tsketch.generate_sketches(task, seed=0)
           for r in _recs(s) if r[0] == "CA"]
    assert sorted({r[3] for r in cas if r[3] > 11}) == [14], cas


def test_gpu_mutations_draw_the_gpu_candidates():
    """The GPU auto-unroll candidates in mutation; a GPU task is taken."""
    task = TTask(CONV56, "cuda")
    st = next(s for s in tsketch.SketchPolicy(task, seed=1)
              .sample_initial_population(16)
              if any(r[0] == "PR" for r in _recs(s)))
    seen = set()
    rng = random.Random(0)
    for _ in range(60):
        child = tsketch.mutate_auto_unroll(st, task, rng)
        if child is not None:
            seen |= {r[3] for r in _recs(child) if r[0] == "PR"}
    assert "auto_unroll_max_step$1024" in seen


# ---------------------------------------------------------------------------
# HardwareParams and the platform registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("target", sorted(
    {p.target for p in PLATFORMS.values()} | {"llvm", "cuda"}))
def test_hardware_params_equal(target):
    assert THW.default_for_target(target) == \
        THW(**vars(JHW.default_for_target(target)))
    assert TTask(CONV56, target).hardware_params.to_record() == \
        JTask(CONV56, target).hardware_params.to_record()


def test_hardware_params_of_non_default_platforms():
    """A registered platform other than the default takes its own core
    count and vector width; the default and bare llvm take the host's."""
    for p in PLATFORMS.values():
        hw = THW.default_for_target(p.target)
        if p.is_gpu:
            assert hw.warp_size == 32 and hw.max_threads_per_block == 1024
        elif jplat.is_default_cpu_platform(jplat.PLATFORMS[p.name]):
            assert hw == THW.default_for_target("llvm")
        else:
            assert (hw.num_cores, hw.vector_unit_bytes) == \
                (p.num_cores, p.vector_unit_bytes)


def test_make_states_on_a_non_default_cpu_platform(jax_python):
    """llvm -mcpu=znver2 (32 cores, 32-byte vectors): InitParallel fuses to
    num_cores x 16, so the pool follows the platform, in both packages."""
    wk = make_workload_key("conv2d_layer",
                           (1, 14, 14, 32, 32, 3, 3, [1, 1], [1, 1]))
    target = "llvm -mcpu=znver2"
    js = jsketch.make_states(JTask(wk, target), 64, seed=5)
    ts = tsketch.make_states(TTask(wk, target), 64, seed=5)
    _same(js, ts)
    assert len(ts) == 64


# ---------------------------------------------------------------------------
# the command lines on a cuda target
# ---------------------------------------------------------------------------


def test_dump_programs_cuda_target(jax_python, tmp_path, capsys):
    """dump_programs --target cuda writes the JAX make_states records of
    the headline pool's command, cut to 64 states."""
    out = str(tmp_path / "pool.json")
    dumped = dump_programs.main(["--workload-key", CONV56, "--target",
                                 "cuda", "--n-states", "64", "--seed",
                                 "2023", "--out", out])
    assert dumped == {out: 64}
    assert "dumped 64 states" in capsys.readouterr().out
    got = tserde.load_records(out)
    jt = JTask(CONV56, "cuda")
    want = [_recs(s) for s in jsketch.make_states(jt, 64, seed=2023)]
    assert [r.inp.step_records for r in got] == want
    assert all(r.inp.task.target == "cuda" for r in got)
    # every record replays to its bound state, in either package
    for rec, line in zip(got[:8], open(out).read().splitlines()):
        jrec = jserde.record_from_json(line)
        assert rec.inp.recover_state(infer_bound=True).to_str() == \
            jrec.inp.recover_state(infer_bound=True).to_str()
