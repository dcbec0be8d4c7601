"""The fused cost head's shared-memory reckoning and W1 route
(``ops/fused_head.py::smem_plan``), as a pure function of the widths: the
float32 instance's one route on the CUDA cores, and the bfloat16
instance's choice between W1 resident in shared memory and W1 streamed
through the weight ring. The constants it mirrors are read from the
kernel's source; on the card, ``tests/test_torch_kernels_cuda.py`` holds
the reckoning against the kernel's own C functions."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vae_extent_search_tpu_torch.ops import fused_head as fh
from vae_extent_search_tpu_torch.ops.build import MAX_SMEM_BYTES

SOURCE = (Path(fh.__file__).resolve().parents[1] / "csrc"
          / "fused_head.cu").read_text()


def _constexpr(name):
    m = re.search(rf"constexpr int {name} = ([^;]+);", SOURCE)
    assert m, name
    return m.group(1).strip()


def test_the_source_holds_the_mirrored_constants():
    assert int(_constexpr("BM")) == fh.BM
    assert int(_constexpr("KC")) == fh.KC and int(_constexpr("CW")) == fh.CW
    assert int(_constexpr("KS")) == fh.KS and int(_constexpr("KP")) == fh.KP
    assert int(_constexpr("NSTAGE")) == fh.NSTAGE
    assert _constexpr("NWARP") == "NT / 32" and int(_constexpr("NT")) // 32 \
        == fh.NWARP
    assert _constexpr("XROW") == "KS"  # the input chunk's rows are unpadded
    assert _constexpr("CWB") == "NWARP * WN" and int(_constexpr("WN")) * \
        fh.NWARP == fh.CW
    # the kernel refuses what a block cannot take, as the wrapper does
    assert f"smem > {MAX_SMEM_BYTES}" in SOURCE


def test_bench_widths_keep_w1_resident():
    """Hidden 256, latent 64, head 256: W1 [256][264] bf16 beside the three
    bf16 activation buffers, the ring and the row sums, one block of 8
    warps per SM."""
    route, nbytes = fh.smem_plan(True, 256, 256, 256)
    parts = {"w1": 256 * 264 * 2, "buffers": 3 * 32 * 264 * 2,
             "ring": 3 * (16 * 264 + 32 * 16) * 2, "row_sums": 8 * 32 * 4}
    assert parts == {"w1": 135_168, "buffers": 50_688, "ring": 28_416,
                     "row_sums": 1_024}
    assert (route, nbytes) == ("resident", sum(parts.values())) == \
        ("resident", 215_296)
    assert MAX_SMEM_BYTES // nbytes == 1
    assert fh.smem_bytes("streamed", 256, 256, 256) == nbytes - parts["w1"]


def test_f32_keeps_its_reckoning():
    """Three [width][32] f32 buffers, a 16 x 256 f32 chunk and the row
    sums: 115,200 bytes at width 256, two blocks per SM."""
    assert fh.smem_plan(False, 256, 256, 256) == ("fma", 115_200)
    for width in (16, 17, 100, 300, 560):
        w4 = -(-width // 4) * 4
        assert fh.smem_bytes("fma", width, 64, 64) == \
            4 * (3 * w4 * 32 + 16 * 256 + 4 * 32)


# the shape grid of the card tests: W1 resident wherever it fits beside
# the rest; the 300-wide head streams it
@pytest.mark.parametrize("hid,lat,hp,route", [
    (128, 8, 128, "resident"), (256, 64, 256, "resident"),
    (128, 32, 128, "resident"), (200, 10, 100, "resident"),
    (64, 16, 300, "streamed"), (256, 64, 384, "streamed"),
    (512, 64, 256, "streamed"), (256, 256, 256, "resident")])
def test_route_by_widths(hid, lat, hp, route):
    got, nbytes = fh.smem_plan(True, max(hid, lat, hp, 16), hp, hp)
    assert got == route and nbytes <= MAX_SMEM_BYTES
    assert fh.smem_plan(False, max(hid, lat, hp, 16), hp, hp)[0] == "fma"


@pytest.mark.parametrize("width", list(range(16, 1120, 24)))
def test_bf16_takes_every_width_f32_takes(width):
    """The resident route wherever it fits, else the streamed one, which
    always takes less; every width the f32 instance takes (up to 560), the
    bf16 instance takes too (and more: up to ~1,040)."""
    res = fh.smem_bytes("resident", width, width, width)
    stream = fh.smem_bytes("streamed", width, width, width)
    assert stream < res
    f32_ok = fh.smem_bytes("fma", width, width, width) <= MAX_SMEM_BYTES
    try:
        route, nbytes = fh.smem_plan(True, width, width, width)
    except ValueError:
        assert not f32_ok and stream > MAX_SMEM_BYTES
        return
    assert route == ("resident" if res <= MAX_SMEM_BYTES else "streamed")
    assert nbytes == (res if route == "resident" else stream)
    if width <= 256:
        assert route == "resident"


@pytest.mark.parametrize("bf16,width", [(False, 564), (False, 820),
                                        (True, 1100), (True, 1200)])
def test_plan_refuses_widths_no_route_takes(bf16, width):
    with pytest.raises(ValueError, match="shared memory"):
        fh.smem_plan(bf16, width, width, width)


def test_unknown_route_is_refused():
    with pytest.raises(ValueError, match="route"):
        fh.smem_bytes("tf32", 256, 256, 256)


def test_cpu_wrapper_counts_no_route():
    """On a CPU tensor the wrapper runs the plain version: no launch and
    no route counted, in either dtype."""
    rng = np.random.default_rng(0)

    def dense(i, o):
        return {"w": torch.as_tensor(rng.standard_normal((i, o)),
                                     dtype=torch.float32),
                "b": torch.as_tensor(rng.standard_normal(o),
                                     dtype=torch.float32)}

    head = [dense(8, 32), dense(32, 32), dense(32, 1)]
    before = (fh.fused_head_stats.launches, dict(fh.fused_head_stats.routes))
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.as_tensor(rng.standard_normal((40, 8)),
                            dtype=torch.float32).to(dtype)
        out = fh.fused_head_stats(head, x, 3, T=3)
        assert all(o.shape == (40,) and o.dtype == torch.float32
                   for o in out)
    assert (fh.fused_head_stats.launches, fh.fused_head_stats.routes) == \
        before


def _head_case(seed, n=64, d=12, hid=48, lat=8, hp=40):
    rng = np.random.default_rng(seed)

    def dense(i, o):
        bw = np.sqrt(3.0 / i)
        return {"w": torch.as_tensor(rng.uniform(-bw, bw, (i, o)),
                                     dtype=torch.float32),
                "b": torch.as_tensor(rng.uniform(-bw, bw, o),
                                     dtype=torch.float32)}

    enc = ([dense(d, hid), dense(hid, hid)], dense(hid, lat))
    head = [dense(lat, hp), dense(hp, hp), dense(hp, 1)]
    x = torch.as_tensor(rng.standard_normal((n, d)),
                        dtype=torch.float32).to(torch.bfloat16)
    return head, x, enc


def test_kink_flips_hold_the_plain_gnorm_and_its_flips():
    """Flipping nothing is not among the variants; each variant changes a
    row's gnorm (the mask changed), the single flips come nearest first,
    and a variant's |a| and input ulps are its flipped units' largest."""
    head, x, enc = _head_case(1)
    with torch.no_grad():
        _, gnorm, _ = fh.fused_head_passes_plain(head, x, 1, 0.1,
                                                 mask_bits=torch.zeros(
                                                     1, 64, 40,
                                                     dtype=torch.uint32),
                                                 encoder=enc)
        alt, a_abs, ulps = fh.gnorm_kink_flips_plain(head, x, enc, nearest=4)
    assert alt.shape == a_abs.shape == ulps.shape == (64, 4 + 6)
    assert torch.isfinite(alt).all() and torch.isfinite(ulps).all()
    assert (alt != gnorm[:, None]).any(1).all()
    assert (ulps[:, :4].diff(dim=1) >= 0).all()
    # the pair (0, 1) reaches as far as its farther unit, the second
    assert torch.equal(ulps[:, 4], ulps[:, 1])
    assert torch.equal(a_abs[:, 4], torch.maximum(a_abs[:, 0], a_abs[:, 1]))


def test_bf16_ulp():
    v = torch.tensor([1.0, 1.5, 0.75, 3.0e-3, 0.0])
    assert fh._bf16_ulp(v).tolist() == [2.0 ** -7, 2.0 ** -7, 2.0 ** -8,
                                        2.0 ** -16, 0.0]
    # a bf16 value and its neighbour differ by one ulp
    b = torch.tensor([1.0, 0.75, 3.0e-3]).to(torch.bfloat16)
    nxt = (b.view(torch.int16) + 1).view(torch.bfloat16)
    assert torch.equal((nxt.float() - b.float()), fh._bf16_ulp(b.float()))


def _flip_case(seed):
    """(head, x, enc, ref gnorm, variants, their input ulps, scale)"""
    head, x, enc = _head_case(seed)
    with torch.no_grad():
        ref = fh.fused_head_stats_plain(head, x, 1, 0.1, mask_bits=torch.zeros(
            1, 64, 40, dtype=torch.uint32), encoder=enc)[1]
        alt, _, ulps = fh.gnorm_kink_flips_plain(head, x, enc)
    return head, x, enc, ref, alt, ulps, float(ref.abs().max())


@pytest.mark.parametrize("seed", [2, 3])
def test_gnorm_errors_explain_a_flip_near_the_kink_and_nothing_else(seed):
    """A kernel whose gnorm took one row's unit within KINK_ULPS input ulps
    across its kink is within tolerance, with one row counted at a kink
    and that unit's distance reported; a gnorm off by half the largest one
    on a row is not explained."""
    head, x, enc, ref, alt, ulps, scale = _flip_case(seed)
    jump = (alt[:, 0] - ref).abs() / scale
    near = (ulps[:, 0] <= fh.KINK_ULPS) & (jump > 2e-2)
    assert near.any()
    row = int(torch.where(near, jump, torch.zeros_like(jump)).argmax())
    flipped = ref.clone()
    flipped[row] = alt[row, 0]
    with torch.no_grad():
        check = fh.gnorm_errors(flipped, ref, head, x, enc)
        assert check.err <= 2e-2 and check.kinks == 1
        assert check.flipped_ulps_max == float(ulps[row, 0])
        assert fh.gnorm_errors(ref, ref, head, x, enc) == (0.0, 0, 0.0, 0.0)
        off = ref.clone()
        off[row] = ref[row] + 0.5 * scale
        check = fh.gnorm_errors(off, ref, head, x, enc)
    assert check.err > 2e-2 and check.kinks == 0


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_gnorm_errors_refuse_a_flip_far_from_the_kink(seed, monkeypatch):
    """A mask error on a row whose nearest unit lies past KINK_ULPS input
    ulps from its kink is a fault, not another summation order: it stays
    counted at its full error, and allowing more ulps would explain it."""
    head, x, enc, ref, alt, ulps, scale = _flip_case(seed)
    jump = (alt[:, 0] - ref).abs() / scale
    far = (ulps[:, 0] > fh.KINK_ULPS) & (jump > 2e-2)
    assert far.any()
    row = int(torch.where(far, jump, torch.zeros_like(jump)).argmax())
    flipped = ref.clone()
    flipped[row] = alt[row, 0]
    with torch.no_grad():
        check = fh.gnorm_errors(flipped, ref, head, x, enc)
        assert check.kinks == 0 and check.err == pytest.approx(
            float(jump[row]))
        monkeypatch.setattr(fh, "KINK_ULPS", float(ulps[row, 0]))
        wide = fh.gnorm_errors(flipped, ref, head, x, enc)
    assert wide.kinks == 1 and wide.err <= 2e-2


@pytest.mark.parametrize("L,H0,H1,want", [
    (64, 256, 256, True), (10, 100, 100, True), (8, 128, 128, True),
    (300, 16, 16, False), (64, 16, 300, True), (256, 64, 64, False)])
def test_w0_resident_by_widths(L, H0, H1, want):
    """gz reads W0 from W1's region wherever W0 [round16(L)][round16(H0) +
    8] fits where W1 [round16(H0)][round16(H1) + 8] was: at the bench
    widths it takes 33,792 of W1's 135,168 bytes."""
    assert fh.w0_resident(L, H0, H1) is want
