"""Inference of TenSet relay-hash workloads from their argument signatures.

A copy of ``vae_extent_search_tpu/records/tenset_workloads.py``.

TenSet workload keys are ``[dag_hash, *flattened I/O shapes]`` produced by
relay task extraction (reference relay_integration.py:82-149); the hash ->
DAG mapping normally comes from ``all_tasks.pkl``
(scripts/common.py:68-75). Without that pickle we reconstruct the relay
fusion-group patterns from the shape signature:

- NHWC conv2d [+ broadcast adds] [+ relu] chains (the resnet/mobilenet
  conv groups)
- max/avg pooling groups (with optional pre-bias)
- global average pool (out H == W == 1)
- dense [+ bias] and softmax groups

Known hashes can also be registered exactly via
``workload.register_workload_shape_builder``. Reconstruction targets the
loop structure (stage count and iteration domains match the relay
lowering), which is what record replay and featurization consume.
"""

from __future__ import annotations

from typing import List, Optional

from ..ir import expr as E
from ..ir.tensor import (
    Tensor,
    compute,
    max_reduce,
    placeholder,
    reduce_axis,
    sum_reduce,
)


def _pad_nhwc(data, pt, pl, pb, pr, name="PaddedInput", pad_value=0.0,
              force=False):
    if pt == 0 and pl == 0 and pb == 0 and pr == 0:
        if not force:
            return data
        # topi's identity pad (pad=0 but the stage is kept for stage-
        # count parity) has NO select branch — which makes it strictly
        # inlineable, exactly like the reference's 1x1-conv PaddedInput
        # (resnet-50 ci_log records CI it in the sketch;
        # compute_dag.cc:350 has_branch would otherwise veto)
        return compute(
            data.shape,
            lambda *axs: data[tuple(a.var for a in axs)],
            name,
        )
    N, H, W, C = data.shape

    def fcompute(n, h, w, c):
        cond = E.And(
            (h.var >= pt, h.var < H + pt, w.var >= pl, w.var < W + pl)
        )
        return E.Select(
            cond, data[n.var, h.var - pt, w.var - pl, c.var],
            E.FloatImm(pad_value),
        )

    return compute((N, H + pt + pb, W + pl + pr, C), fcompute, name)


def _broadcast_chain(cur, out_shape, extra_shapes, relu):
    """Append broadcast adds + optional relu (relay T_add / T_relu)."""
    outs = []
    for shape in extra_shapes:
        extra = placeholder(shape, name="placeholder")
        outs.append(extra)
        prev = cur

        def fadd(*axs, prev=prev, extra=extra, shape=shape):
            idx = []
            off = len(out_shape) - len(shape)
            for d, s in enumerate(shape):
                i = axs[d + off].var
                idx.append(i if s > 1 else E.IntImm(0))
            return prev[tuple(a.var for a in axs)] + extra[tuple(idx)]

        cur = compute(out_shape, fadd, "T_add")
    if relu:
        prev = cur
        cur = compute(
            out_shape,
            lambda *axs, prev=prev: E.Max(
                prev[tuple(a.var for a in axs)], E.FloatImm(0.0)
            ),
            "T_relu",
        )
    return outs, cur


def conv2d_nhwc_chain(data_shape, kernel_shape, out_shape,
                      extra_shapes=(), relu=False) -> List[Tensor]:
    """NHWC conv2d (stride/padding inferred) + broadcast adds + relu."""
    N, H, W, CI = data_shape
    KH, KW, _, CO = kernel_shape
    _, OH, OW, _ = out_shape
    # resolve (stride, pad): OH == (H + 2p - KH) // s + 1 with the usual
    # relay choices (p in 0..KH, preferring SAME-style p = KH//2)
    stride, ph = None, 0
    pad_prefs = sorted(range(0, KH + 1), key=lambda p: abs(p - KH // 2))
    for s in (1, 2, 3, 4):
        for p in pad_prefs:
            if (H + 2 * p - KH) // s + 1 == OH:
                stride, ph = s, p
                break
        if stride is not None:
            break
    if stride is None:
        stride, ph = 1, max(0, ((OH - 1) + KH - H) // 2)
    pw = ph

    data = placeholder(data_shape, name="placeholder")
    kernel = placeholder(kernel_shape, name="placeholder")
    # topi's conv2d_nhwc constructs PaddedInput unconditionally (identity
    # pad when padding is 0) — stage counts in relay records rely on it
    pad = _pad_nhwc(data, ph, pw, ph, pw, force=True)
    rh = reduce_axis(KH, "ry")
    rw = reduce_axis(KW, "rx")
    rc = reduce_axis(CI, "rc")

    def fconv(n, yy, xx, ff):
        return sum_reduce(
            pad[n.var, yy.var * stride + rh.var, xx.var * stride + rw.var,
                rc.var]
            * kernel[rh.var, rw.var, rc.var, ff.var],
            [rh, rw, rc],
        )

    conv = compute((N, OH, OW, CO), fconv, "Conv2dOutput")
    extras, cur = _broadcast_chain(conv, tuple(out_shape), extra_shapes, relu)
    return [data, kernel] + extras + [cur]


def winograd_nhwc_chain(data_shape, kernel_shape, out_shape,
                        extra_shapes=(), relu=False) -> List[Tensor]:
    """Winograd NHWC conv with pre-transformed kernel (relay
    contrib_conv2d_winograd_without_weight_transform; structure follows
    topi _conv2d_winograd_nhwc_impl: data_pad -> input_tile -> B ->
    data_pack -> bgemm -> A -> inverse -> conv2d_winograd)."""
    N, H, W, CI = data_shape
    alpha = kernel_shape[0]  # transformed kernel [alpha, alpha, CO, CI]
    CO = out_shape[3]
    r = 3
    m = alpha - r + 1
    KH = KW = r
    OH, OW = out_shape[1], out_shape[2]
    pad_t = pad_l = pad_b = pad_r = 1  # 3x3 stride-1 SAME
    nH, nW = (OH + m - 1) // m, (OW + m - 1) // m
    P = N * nH * nW
    pad_extra = (nW - 1) * m + alpha - (OH + pad_t + pad_b)

    data = placeholder(data_shape, name="placeholder")
    kernel = placeholder(kernel_shape, name="placeholder")
    data_pad = _pad_nhwc(data, pad_t, pad_l, pad_b + pad_extra,
                         pad_r + pad_extra, name="data_pad")

    input_tile = compute(
        (alpha, alpha, P, CI),
        lambda eps, nu, p, ci: data_pad[
            p.var // (nH * nW),
            E.FloorMod(p.var // nW, E.IntImm(nH)) * m + eps.var,
            E.FloorMod(p.var, E.IntImm(nW)) * m + nu.var,
            ci.var,
        ],
        "input_tile",
    )
    # B / A constant matrices (const_matrix compute ops; the values are
    # irrelevant for replay/featurization structure)
    Bm = compute((alpha, alpha), lambda i, j: E.FloatImm(1.0), "B")
    r_a = reduce_axis(alpha, "r_a")
    r_b = reduce_axis(alpha, "r_b")
    data_pack = compute(
        (alpha, alpha, P, CI),
        lambda eps, nu, p, ci: sum_reduce(
            input_tile[r_a.var, r_b.var, p.var, ci.var]
            * Bm[r_a.var, eps.var] * Bm[r_b.var, nu.var],
            [r_a, r_b],
        ),
        "data_pack",
    )
    rc = reduce_axis(CI, "ci")
    bgemm = compute(
        (alpha, alpha, P, CO),
        lambda eps, nu, p, co: sum_reduce(
            data_pack[eps.var, nu.var, p.var, rc.var]
            * kernel[eps.var, nu.var, co.var, rc.var],
            [rc],
        ),
        "bgemm",
    )
    Am = compute((alpha, m), lambda i, j: E.FloatImm(1.0), "A")
    r_a2 = reduce_axis(alpha, "r_a")
    r_b2 = reduce_axis(alpha, "r_b")
    inverse = compute(
        (m, m, P, CO),
        lambda vh, vw, p, co: sum_reduce(
            bgemm[r_a2.var, r_b2.var, p.var, co.var]
            * Am[r_a2.var, vh.var] * Am[r_b2.var, vw.var],
            [r_a2, r_b2],
        ),
        "inverse",
    )
    output = compute(
        (N, OH, OW, CO),
        lambda n, h, w, co: inverse[
            E.FloorMod(h.var, E.IntImm(m)),
            E.FloorMod(w.var, E.IntImm(m)),
            n.var * (nH * nW) + (h.var // m) * nW + (w.var // m),
            co.var,
        ],
        "conv2d_winograd",
    )
    extras, cur = _broadcast_chain(output, tuple(out_shape), extra_shapes,
                                   relu)
    return [data, kernel] + extras + [cur]


def pool2d_chain(data_shape, out_shape, extra_shapes=(), relu=False,
                 pool="max") -> List[Tensor]:
    """NHWC max/avg pool (kernel/stride inferred) + adds + relu."""
    N, H, W, C = data_shape
    _, OH, OW, _ = out_shape
    stride = max(1, H // max(1, OH))
    # typical relay pools: 3x3 s2 p1 (resnet) or 2x2 s2
    for k, p in ((3, 1), (2, 0), (3, 0)):
        if (H + 2 * p - k) // stride + 1 == OH:
            kk, pp = k, p
            break
    else:
        kk, pp = stride, 0

    data = placeholder(data_shape, name="placeholder")
    pad = _pad_nhwc(data, pp, pp, pp, pp, name="pad_temp",
                    pad_value=-1e30 if pool == "max" else 0.0)
    kh = reduce_axis(kk, "rv0")
    kw = reduce_axis(kk, "rv1")

    if pool == "max":
        out = compute(
            (N, OH, OW, C),
            lambda n, h, w, c: max_reduce(
                pad[n.var, h.var * stride + kh.var, w.var * stride + kw.var,
                    c.var],
                [kh, kw],
            ),
            "pool_max",
        )
    else:
        ssum = compute(
            (N, OH, OW, C),
            lambda n, h, w, c: sum_reduce(
                pad[n.var, h.var * stride + kh.var, w.var * stride + kw.var,
                    c.var],
                [kh, kw],
            ),
            "pool_sum",
        )
        out = compute(
            (N, OH, OW, C),
            lambda n, h, w, c: ssum[n.var, h.var, w.var, c.var]
            / float(kk * kk),
            "pool_avg",
        )
    extras, cur = _broadcast_chain(out, tuple(out_shape), extra_shapes, relu)
    return [data] + extras + [cur]


def global_avg_pool_chain(data_shape, out_shape) -> List[Tensor]:
    """adaptive_avg_pool2d to 1x1 (relay: sum reduce + divide)."""
    N, H, W, C = data_shape
    data = placeholder(data_shape, name="placeholder")
    rh = reduce_axis(H, "rv0")
    rw = reduce_axis(W, "rv1")
    ssum = compute(
        (N, 1, 1, C),
        lambda n, h, w, c: sum_reduce(data[n.var, rh.var, rw.var, c.var],
                                      [rh, rw]),
        "adaptive_pool_sum",
    )
    out = compute(
        (N, 1, 1, C),
        lambda n, h, w, c: ssum[n.var, h.var, w.var, c.var] / float(H * W),
        "adaptive_pool_avg",
    )
    return [data, out]


def dense_chain(data_shape, weight_shape, out_shape,
                extra_shapes=(), relu=False) -> List[Tensor]:
    """dense (weight [out, in]) + bias adds + relu."""
    B, I = data_shape
    O = out_shape[-1]
    data = placeholder(data_shape, name="placeholder")
    weight = placeholder((O, I), name="placeholder")
    k = reduce_axis(I, "k")
    mm = compute(
        (B, O),
        lambda i, j: sum_reduce(data[i.var, k.var] * weight[j.var, k.var],
                                [k]),
        # topi nn.dense names its output "T_dense"
        # (reference topi/nn/dense.py:66-70); the workload-embedding tag
        # "dense" keys on it
        "T_dense",
    )
    extras, cur = _broadcast_chain(mm, tuple(out_shape), extra_shapes, relu)
    return [data, weight] + extras + [cur]


def softmax_chain(data_shape) -> List[Tensor]:
    N, M = data_shape
    A = placeholder(data_shape, name="placeholder")
    k1 = reduce_axis(M, "k")
    mx = compute((N,), lambda i: max_reduce(A[i.var, k1.var], [k1]),
                 "T_softmax_maxelem")
    ex = compute((N, M), lambda i, j: E.exp(A[i.var, j.var] - mx[i.var]),
                 "T_softmax_exp")
    k2 = reduce_axis(M, "k")
    sm = compute((N,), lambda i: sum_reduce(ex[i.var, k2.var], [k2]),
                 "T_softmax_expsum")
    out = compute((N, M), lambda i, j: ex[i.var, j.var] / sm[i.var],
                  "T_softmax_norm")
    return [A, out]


def _infer_conv_stride_pad(H, KH, OH, strides=(1, 2, 3, 4)):
    """Resolve (stride, pad) with OH == (H + 2p - KH)//s + 1, preferring
    SAME-style p = KH//2 (the usual relay choices)."""
    pad_prefs = sorted(range(0, KH + 1), key=lambda p: abs(p - KH // 2))
    for s in strides:
        for p in pad_prefs:
            if (H + 2 * p - KH) // s + 1 == OH:
                return s, p
    return 1, max(0, ((OH - 1) + KH - H) // 2)


def depthwise_nhwc_chain(data_shape, kernel_shape, out_shape,
                         extra_shapes=(), relu=False) -> List[Tensor]:
    """NHWC depthwise conv (topi depthwise_conv2d_nhwc, kernel
    [KH, KW, C, channel_multiplier]; reference
    python/tvm/topi/nn/depthwise_conv2d.py:178-254) + broadcast adds +
    relu — the mobilenet-family 3x3 groups."""
    N, H, W, C = data_shape
    KH, KW, _, mult = kernel_shape
    _, OH, OW, CO = out_shape
    stride, p = _infer_conv_stride_pad(H, KH, OH)

    data = placeholder(data_shape, name="placeholder")
    kernel = placeholder(kernel_shape, name="placeholder")
    pad = _pad_nhwc(data, p, p, p, p, force=True)
    rh = reduce_axis(KH, "ry")
    rw = reduce_axis(KW, "rx")

    def fdw(n, yy, xx, cc):
        ci = cc.var // mult if mult > 1 else cc.var
        mi = cc.var % mult if mult > 1 else E.IntImm(0)
        return sum_reduce(
            pad[n.var, yy.var * stride + rh.var, xx.var * stride + rw.var,
                ci]
            * kernel[rh.var, rw.var, ci, mi],
            [rh, rw],
        )

    conv = compute((N, OH, OW, CO), fdw, "DepthwiseConv2d")
    extras, cur = _broadcast_chain(conv, tuple(out_shape), extra_shapes,
                                   relu)
    return [data, kernel] + extras + [cur]


def group_conv2d_nhwc_chain(data_shape, kernel_shape, out_shape,
                            extra_shapes=(), relu=False) -> List[Tensor]:
    """NHWC grouped conv (kernel HWIO [KH, KW, CI/G, CO]; output channel
    ff reads input block ff//(CO/G)*(CI/G)+rc, cf. reference
    python/tvm/topi/nn/conv2d.py:798-870) — the resnext-family 3x3
    groups."""
    N, H, W, CI = data_shape
    KH, KW, ci_pg, CO = kernel_shape
    _, OH, OW, _ = out_shape
    groups = CI // ci_pg
    co_pg = CO // groups
    stride, p = _infer_conv_stride_pad(H, KH, OH)

    data = placeholder(data_shape, name="placeholder")
    kernel = placeholder(kernel_shape, name="placeholder")
    pad = _pad_nhwc(data, p, p, p, p, force=True)
    rh = reduce_axis(KH, "ry")
    rw = reduce_axis(KW, "rx")
    rc = reduce_axis(ci_pg, "rc")

    def fconv(n, yy, xx, ff):
        return sum_reduce(
            pad[n.var, yy.var * stride + rh.var, xx.var * stride + rw.var,
                ff.var // co_pg * ci_pg + rc.var]
            * kernel[rh.var, rw.var, rc.var, ff.var],
            [rh, rw, rc],
        )

    conv = compute((N, OH, OW, CO), fconv, "group_conv2d_nhwc")
    extras, cur = _broadcast_chain(conv, tuple(out_shape), extra_shapes,
                                   relu)
    return [data, kernel] + extras + [cur]


def conv2d_transpose_nhwc_chain(data_shape, kernel_shape, out_shape,
                                extra_shapes=(), relu=False) -> List[Tensor]:
    """NHWC transposed conv (topi conv2d_transpose_nhwc, reference
    python/tvm/topi/nn/conv2d_transpose.py:119-211): explicit pad stage
    in input space, then one conv stage with the stride-dilation
    embedded as a mod-select and the HWIO kernel rotated 180 degrees —
    the dcgan generator groups."""
    N, H, W, CI = data_shape
    KH, KW, _, CO = kernel_shape
    _, OH, OW, _ = out_shape
    # OH = (H-1)*s - 2p + KH (+output_padding, assumed absorbed): relay
    # dcgan uses s=2, p=(KH-1)//2; infer s from the upsample ratio
    stride = max(1, int(round(OH / H)))
    p = max(0, ((H - 1) * stride + KH - OH) // 2)
    bp = KH - 1 - p
    pp = (bp + stride - 1) // stride  # ceildiv: pad in input space
    border = (stride - bp % stride) % stride

    data = placeholder(data_shape, name="placeholder")
    kernel = placeholder(kernel_shape, name="placeholder")
    pad = _pad_nhwc(data, pp, pp, pp, pp, force=True)
    rh = reduce_axis(KH, "rh")
    rw = reduce_axis(KW, "rw")
    rc = reduce_axis(CI, "rc")

    def fconv(n, h, w, co):
        hh = h.var + rh.var + E.IntImm(border)
        ww = w.var + rw.var + E.IntImm(border)
        keep = E.And(((hh % stride).equal(0), (ww % stride).equal(0)))
        val = E.Select(
            keep, pad[n.var, hh // stride, ww // stride, rc.var],
            E.FloatImm(0.0),
        )
        return sum_reduce(
            val * kernel[KH - 1 - rh.var, KW - 1 - rw.var, rc.var, co.var],
            [rh, rw, rc],
        )

    conv = compute((N, OH, OW, CO), fconv, "conv2d_transpose_nhwc")
    extras, cur = _broadcast_chain(conv, tuple(out_shape), extra_shapes,
                                   relu)
    return [data, kernel] + extras + [cur]


def conv3d_ndhwc_chain(data_shape, kernel_shape, out_shape,
                       extra_shapes=(), relu=False) -> List[Tensor]:
    """NDHWC conv3d (topi conv3d_ndhwc, kernel [KD, KH, KW, CI, CO];
    reference python/tvm/topi/nn/conv3d.py:107-196) + broadcast adds +
    relu — the resnet3d-family groups."""
    N, D, H, W, CI = data_shape
    KD, KH, KW, _, CO = kernel_shape
    _, OD, OH, OW, _ = out_shape
    stride, p = _infer_conv_stride_pad(H, KH, OH)
    sd, pd = _infer_conv_stride_pad(D, KD, OD)

    data = placeholder(data_shape, name="placeholder")
    kernel = placeholder(kernel_shape, name="placeholder")

    def fpad(n, d, h, w, c):
        if pd == 0 and p == 0:
            # identity pad is branch-free (topi pad semantics; keeps
            # the stage strictly inlineable like the reference)
            return data[n.var, d.var, h.var, w.var, c.var]
        cond = E.And((
            d.var >= pd, d.var < D + pd,
            h.var >= p, h.var < H + p,
            w.var >= p, w.var < W + p,
        ))
        return E.Select(
            cond, data[n.var, d.var - pd, h.var - p, w.var - p, c.var],
            E.FloatImm(0.0),
        )

    pad = compute((N, D + 2 * pd, H + 2 * p, W + 2 * p, CI), fpad,
                  "PaddedInput")
    rd = reduce_axis(KD, "rd")
    rh = reduce_axis(KH, "ry")
    rw = reduce_axis(KW, "rx")
    rc = reduce_axis(CI, "rc")

    def fconv(n, dd, yy, xx, ff):
        return sum_reduce(
            pad[n.var, dd.var * sd + rd.var, yy.var * stride + rh.var,
                xx.var * stride + rw.var, rc.var]
            * kernel[rd.var, rh.var, rw.var, rc.var, ff.var],
            [rd, rh, rw, rc],
        )

    conv = compute((N, OD, OH, OW, CO), fconv, "Conv3dOutput")
    extras, cur = _broadcast_chain(conv, tuple(out_shape), extra_shapes,
                                   relu)
    return [data, kernel] + extras + [cur]


def _try_conv3d_split(args):
    """5-int shape groups (NDHWC conv3d): only accepted when a kernel
    [KD,KH,KW,CI,CO] consistent with data/out channels exists — a 20-int
    signature is otherwise ambiguous with five 4-d shapes."""
    if len(args) % 5 != 0 or len(args) < 15:
        return None
    shapes = [tuple(args[i:i + 5]) for i in range(0, len(args), 5)]
    data, out = shapes[0], shapes[-1]
    if data[0] != out[0]:
        return None
    kernel, extras = None, []
    for s in shapes[1:-1]:
        if (kernel is None and s[3] == data[4] and s[4] == out[4]
                and s[0] <= 16 and s[1] <= 16 and s[2] <= 16):
            kernel = s
        else:
            extras.append(s)
    if kernel is None:
        return None
    relu = any(s[0] == 1 and s[1] == 1 and s[2] == 1 and s[3] == 1
               for s in extras)
    return conv3d_ndhwc_chain(data, kernel, out, extras, relu=relu)


def batch_matmul_chain(x_shape, y_shape, out_shape) -> List[Tensor]:
    """Batched NT matmul (topi nn.batch_matmul: out[b,i,j] =
    sum_k X[b,i,k]*Y[b,j,k]) — the bert attention groups."""
    B, M, K = x_shape
    _, N_, _ = y_shape
    X = placeholder(x_shape, name="placeholder")
    Y = placeholder(y_shape, name="placeholder")
    k = reduce_axis(K, "k")
    out = compute(
        tuple(out_shape),
        lambda b, i, j: sum_reduce(
            X[b.var, i.var, k.var] * Y[b.var, j.var, k.var], [k]
        ),
        # unnamed te.compute in topi batch_matmul -> default "compute"
        # (reference topi/nn/batch_matmul.py:70-75)
        "compute",
    )
    return [X, Y, out]


def _parse_dense_bias(args):
    """[B, I, O, I2, O2, B2, O3] pattern: dense + 1-d bias (+relu)."""
    if len(args) == 7:
        B, I, O, I2, O3, B2, O4 = args
        if I == I2 and O == O3 == O4 and B == B2:
            return dense_chain((B, I), (O, I), (B, O), [(1, O)], relu=False)
    return None


def _group_shapes(args):
    """Split the flat int list into 4-d/2-d shape groups, greedy 4 first
    when the total length is divisible and yields >= 2 groups."""
    if len(args) % 4 == 0 and len(args) >= 8:
        return [tuple(args[i:i + 4]) for i in range(0, len(args), 4)]
    if len(args) % 2 == 0:
        return [tuple(args[i:i + 2]) for i in range(0, len(args), 2)]
    return None


def infer_tenset_workload(dag_hash: str, args) -> Optional[List[Tensor]]:
    """Best-effort relay fusion-group reconstruction from shape args."""
    if not args or not all(isinstance(a, int) for a in args):
        return None
    special = _parse_dense_bias(list(args))
    if special is not None:
        return special
    if len(args) == 9:
        # three 3-d shapes: batched NT matmul [B,M,K] x [B,N,K] -> [B,M,N]
        x, y, out = tuple(args[0:3]), tuple(args[3:6]), tuple(args[6:9])
        if (x[0] == y[0] == out[0] and x[2] == y[2]
                and out[1] == x[1] and out[2] == y[1]):
            return batch_matmul_chain(x, y, out)
    conv3d = _try_conv3d_split(list(args))
    if conv3d is not None:
        return conv3d
    shapes = _group_shapes(list(args))
    if not shapes or len(shapes) < 2:
        return None
    data, out = shapes[0], shapes[-1]
    mids = shapes[1:-1]

    if len(data) == 2:
        # dense / softmax family
        if not mids and data == out:
            return softmax_chain(data)
        if mids:
            weight = mids[0]
            extras = [s for s in mids[1:]]
            return dense_chain(data, weight, out, extras,
                               relu=bool(extras))
        return None

    if len(data) == 4 and len(out) == 4:
        # global avg pool
        if out[1] == 1 and out[2] == 1 and data[3] == out[3] and not mids:
            return global_avg_pool_chain(data, out)

        def is_bias(s):
            return len(s) == 4 and s[0] == 1 and s[1] == 1 and s[2] == 1

        # winograd: pre-transformed kernel [alpha, alpha, CO, CI] with
        # alpha in (4, 6) and stride-1 same-size output
        kernel = None
        wino = dw = grp = False
        extras = []
        for s in mids:
            if (
                kernel is None and len(s) == 4 and s[0] == s[1]
                and s[0] in (4, 6) and s[3] == data[3]
                and s[2] == out[3] and data[1] == out[1]
            ):
                kernel = s
                wino = True
            elif kernel is None and len(s) == 4 and s[2] == data[3] \
                    and s[3] == out[3] and s[0] <= 16 and s[1] <= 16:
                kernel = s
            elif kernel is None and len(s) == 4 and s[2] == data[3] \
                    and s[3] == 1 and out[3] == data[3] \
                    and 1 < s[0] <= 16 and 1 < s[1] <= 16:
                # HWC1 kernel, C preserved: depthwise (multiplier 1)
                kernel = s
                dw = True
            elif kernel is None and len(s) == 4 and 1 < s[2] < data[3] \
                    and data[3] % s[2] == 0 and s[3] == out[3] \
                    and s[0] <= 16 and s[1] <= 16:
                # HWIO kernel with I a proper divisor of CI (I > 1 —
                # an 1x1x1xC shape is a broadcast bias): grouped conv
                kernel = s
                grp = True
            else:
                extras.append(s)
        # fused relu iff a broadcast-bias extra is present (residual-only
        # groups end at the add; cf. resnet ci_log stage counts)
        relu = any(is_bias(s) for s in extras)
        if kernel is not None and wino:
            return winograd_nhwc_chain(data, kernel, out, extras, relu=relu)
        if kernel is not None and dw:
            return depthwise_nhwc_chain(data, kernel, out, extras,
                                        relu=relu)
        if kernel is not None and grp:
            return group_conv2d_nhwc_chain(data, kernel, out, extras,
                                           relu=relu)
        if kernel is not None and out[1] > data[1]:
            # upsampling conv group: transposed convolution (dcgan)
            return conv2d_transpose_nhwc_chain(data, kernel, out, extras,
                                               relu=relu)
        if kernel is not None:
            return conv2d_nhwc_chain(data, kernel, out, extras, relu=relu)
        # no kernel group: pooling (possibly with bias-ish extras)
        if data[3] == out[3]:
            return pool2d_chain(data, out, extras, relu=relu, pool="max")
    return None
