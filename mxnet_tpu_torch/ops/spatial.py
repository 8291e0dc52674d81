"""Spatial operators: GridGenerator, BilinearSampler, SpatialTransformer,
ROIPooling and Correlation (counterparts of ``mxnet_tpu/ops/spatial.py``;
ref: src/operator/grid_generator-inl.h, bilinear_sampler-inl.h,
spatial_transformer-inl.h, roi_pooling.cc, correlation-inl.h).

Each computes what the JAX function computes, in PyTorch operations on the
inputs' device, without carrying the JAX formulation over where it does not
fit the memory of a full-size call:

- ROIPooling takes the maximum of each bin in chunks of rois, and its
  backward is written by hand: the JAX package's masked tensor of
  ``(R, C, ph, pw, H, W)`` would hold 7.7e9 values at Fast R-CNN's size.
  The backward splits a bin's gradient evenly among the elements tied at
  its maximum, as JAX's ``max`` does.
- Correlation reads each displacement's window by slicing. The JAX package
  shifts with ``jnp.roll``, but every output position lies at least
  ``max_displacement + kernel_size // 2`` inside the padded map, so no
  value it reads wraps around: the two agree everywhere.
- BilinearSampler gathers the four neighbours with the JAX package's
  arithmetic, so a grid point on a pixel edge takes the same cell (and the
  same gradient) in both.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import attr_bool, attr_float, attr_int, attr_str, attr_tuple, \
    MXNetError
from .registry import register


# ---------------------------------------------------------------------------
# GridGenerator (ref: grid_generator-inl.h): (N, 2, H, W) sampling grids
# with x, y in [-1, 1]
# ---------------------------------------------------------------------------

def affine_grid(theta, h, w):
    """The grid of the affine maps ``theta`` (N, 6) at an H x W target."""
    n = theta.shape[0]
    ys = torch.linspace(-1.0, 1.0, h, dtype=theta.dtype, device=theta.device)
    xs = torch.linspace(-1.0, 1.0, w, dtype=theta.dtype, device=theta.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)]).reshape(3, -1)
    return torch.matmul(theta.reshape(n, 2, 3), base).reshape(n, 2, h, w)


def _grid_type(attrs):
    return attr_str(attrs.get("transform_type", "affine"), "affine")


def _grid_gen_infer(attrs, in_shapes):
    data = in_shapes[0]
    if data is None:
        raise MXNetError("GridGenerator: data shape required")
    if _grid_type(attrs) == "affine":
        return ([(data[0], 6)],
                [(data[0], 2) + tuple(attr_tuple(attrs["target_shape"]))], [])
    return [tuple(data)], [tuple(data)], []


def _grid_gen_unsplit(attrs, ndims):
    return [(0, 1)] if _grid_type(attrs) == "affine" else \
        [(0, 1), (0, 2), (0, 3)]


@register("GridGenerator", inputs=("data",), infer_shape=_grid_gen_infer,
          mesh_split=True, mesh_unsplit=_grid_gen_unsplit)
def _grid_generator(op_ctx, attrs, inputs, aux):
    tt = _grid_type(attrs)
    data = inputs[0]
    if tt == "affine":
        h, w = attr_tuple(attrs["target_shape"])
        return (affine_grid(data, h, w),)
    if tt == "warp":
        # a flow (N, 2, H, W) added to the identity grid, normalised
        n, _, h, w = data.shape
        ys = torch.arange(h, dtype=data.dtype, device=data.device)
        xs = torch.arange(w, dtype=data.dtype, device=data.device)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        x = (gx[None] + data[:, 0]) * 2.0 / max(w - 1, 1) - 1.0
        y = (gy[None] + data[:, 1]) * 2.0 / max(h - 1, 1) - 1.0
        return (torch.stack([x, y], dim=1),)
    raise MXNetError("GridGenerator: unknown transform_type %r" % tt)


# ---------------------------------------------------------------------------
# BilinearSampler (ref: bilinear_sampler-inl.h): ``data`` sampled at the
# grid's points, zero outside [-1, 1]
# ---------------------------------------------------------------------------

def bilinear_sample(data, grid):
    """``data`` (N, C, H, W) at ``grid`` (N, 2, Ho, Wo): each point's four
    neighbours weighted by its distances to them. The gradient with
    respect to the grid flows through the weights (``floor`` has none)."""
    n, c, h, w = data.shape
    gx = (grid[:, 0] + 1.0) * (w - 1) / 2.0
    gy = (grid[:, 1] + 1.0) * (h - 1) / 2.0
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = (gx - x0)[:, None]
    wy = (gy - y0)[:, None]
    flat = data.reshape(n, c, h * w)

    def corner(yi, xi):
        valid = ((xi >= 0) & (xi <= w - 1) & (yi >= 0)
                 & (yi <= h - 1)).to(data.dtype)
        idx = (yi.clamp(0, h - 1).to(torch.int64) * w
               + xi.clamp(0, w - 1).to(torch.int64)).reshape(n, 1, -1)
        vals = torch.gather(flat, 2, idx.expand(n, c, idx.shape[-1]))
        return vals.reshape((n, c) + tuple(xi.shape[1:])) * valid[:, None]

    v00 = corner(y0, x0)
    v01 = corner(y0, x0 + 1)
    v10 = corner(y0 + 1, x0)
    v11 = corner(y0 + 1, x0 + 1)
    return ((1 - wy) * ((1 - wx) * v00 + wx * v01)
            + wy * ((1 - wx) * v10 + wx * v11))


def _same_batch(who, a, b):
    if a is not None and b is not None and a[0] != b[0]:
        raise MXNetError("%s: batch %d of %s against %d of %s"
                         % (who, a[0], tuple(a), b[0], tuple(b)))


def _bilinear_infer(attrs, in_shapes):
    data, grid = in_shapes
    if data is None or grid is None:
        raise MXNetError("BilinearSampler: both input shapes required")
    _same_batch("BilinearSampler", data, grid)
    return [tuple(data), tuple(grid)], \
        [(data[0], data[1], grid[2], grid[3])], []


@register("BilinearSampler", inputs=("data", "grid"),
          infer_shape=_bilinear_infer, mesh_split=True,
          mesh_unsplit=lambda attrs, ndims: [(0, 2), (0, 3), (1, 1)])
def _bilinear_sampler(op_ctx, attrs, inputs, aux):
    return (bilinear_sample(inputs[0], inputs[1]),)


# ---------------------------------------------------------------------------
# SpatialTransformer (ref: spatial_transformer-inl.h): the localisation
# net's affine map -> grid -> bilinear sample
# ---------------------------------------------------------------------------

def _st_infer(attrs, in_shapes):
    data, loc = in_shapes
    if data is None:
        raise MXNetError("SpatialTransformer: data shape required")
    _same_batch("SpatialTransformer", data, loc)
    return [tuple(data), (data[0], 6)], \
        [(data[0], data[1]) + tuple(attr_tuple(attrs["target_shape"]))], []


@register("SpatialTransformer", inputs=("data", "loc"), infer_shape=_st_infer,
          mesh_split=True,
          mesh_unsplit=lambda attrs, ndims: [(0, 2), (0, 3), (1, 1)])
def _spatial_transformer(op_ctx, attrs, inputs, aux):
    data, loc = inputs
    h, w = attr_tuple(attrs["target_shape"])
    if (_grid_type(attrs) != "affine" or attr_str(
            attrs.get("sampler_type", "bilinear"), "bilinear") != "bilinear"):
        raise MXNetError("SpatialTransformer supports affine+bilinear")
    return (bilinear_sample(data, affine_grid(loc, h, w)),)


# ---------------------------------------------------------------------------
# ROIPooling (ref: roi_pooling.cc): the maximum of each of ph x pw bins of
# each roi's window on its image's feature map; an empty bin reads 0
# ---------------------------------------------------------------------------

#: values of the feature map gathered at once for a chunk of rois
ROI_CHUNK_VALUES = 1 << 25


def _roi_infer(attrs, in_shapes):
    data, rois = in_shapes
    ph, pw = attr_tuple(attrs["pooled_size"])
    if data is None or rois is None:
        raise MXNetError("ROIPooling: both input shapes required")
    return [tuple(data), tuple(rois)], [(rois[0], data[1], ph, pw)], []


def roi_bins(rois, scale, ph, pw, h, w):
    """Each roi's image index (R,) and its bins' row and column masks,
    (R, ph, H) and (R, pw, W), from the JAX package's float32 arithmetic
    (whatever the rois' dtype, so a float64 run bins as a float32 one)."""
    r = rois.to(torch.float32)
    dev = rois.device
    x1, y1, x2, y2 = (torch.round(r[:, i] * scale) for i in range(1, 5))
    # divisors as device tensors: CUDA multiplies by the reciprocal of a
    # Python number, a rounding that moves bin edges landing on integers
    ph_t, pw_t = (torch.full((), float(v), device=dev) for v in (ph, pw))
    bin_h = torch.clamp_min(y2 - y1 + 1.0, 1.0) / ph_t
    bin_w = torch.clamp_min(x2 - x1 + 1.0, 1.0) / pw_t

    def masks(n_bins, size, bin_len, start):
        i = torch.arange(n_bins, dtype=torch.float32, device=dev)[None]
        lo = torch.clamp(torch.floor(i * bin_len[:, None] + start[:, None]),
                         0, size - 1)
        hi = torch.clamp(torch.ceil((i + 1) * bin_len[:, None]
                                    + start[:, None]), 1, size)
        pos = torch.arange(size, dtype=torch.float32, device=dev)
        return (pos >= lo[..., None]) & (pos < hi[..., None])

    return (r[:, 0].to(torch.int64), masks(ph, h, bin_h, y1),
            masks(pw, w, bin_w, x1))


def _roi_chunks(data, n_rois):
    per = max(1, ROI_CHUNK_VALUES // max(1, data[0].numel()))
    return [(c, min(c + per, n_rois)) for c in range(0, n_rois, per)]


class _ROIPooling(torch.autograd.Function):

    @staticmethod
    def forward(ctx, data, rois, ph, pw, scale):
        batch, hmask, wmask = roi_bins(rois, scale, ph, pw, data.shape[2],
                                       data.shape[3])
        out = data.new_empty((rois.shape[0], data.shape[1], ph, pw))
        neg = float("-inf")
        for c0, c1 in _roi_chunks(data, rois.shape[0]):
            fm = data.index_select(0, batch[c0:c1])       # (r, C, H, W)
            for i in range(ph):
                # a rectangle's maximum is the maximum of its rows' maxima
                rows = torch.where(hmask[c0:c1, i, None, :, None], fm,
                                   neg).amax(2)           # (r, C, W)
                for j in range(pw):
                    out[c0:c1, :, i, j] = torch.where(
                        wmask[c0:c1, j, None, :], rows, neg).amax(2)
        out = torch.where(torch.isneginf(out), torch.zeros_like(out), out)
        ctx.save_for_backward(data, rois, batch, hmask, wmask, out)
        return out

    @staticmethod
    def backward(ctx, g):
        data, rois, batch, hmask, wmask, out = ctx.saved_tensors
        ph, pw = out.shape[2], out.shape[3]
        grad = torch.zeros_like(data)
        for c0, c1 in _roi_chunks(data, rois.shape[0]):
            fm = data.index_select(0, batch[c0:c1])
            gfm = torch.zeros_like(fm)
            for i in range(ph):
                for j in range(pw):
                    rect = (hmask[c0:c1, i, None, :, None]
                            & wmask[c0:c1, j, None, None, :])
                    tied = rect & (fm == out[c0:c1, :, i, j, None, None])
                    # the bin's gradient split evenly among its maxima
                    share = g[c0:c1, :, i, j] / tied.sum(
                        (2, 3)).clamp_min(1).to(g.dtype)
                    gfm += tied * share[..., None, None]
            grad.index_add_(0, batch[c0:c1], gfm)
        return (grad, torch.zeros_like(rois) if ctx.needs_input_grad[1]
                else None, None, None, None)


@register("ROIPooling", inputs=("data", "rois"), infer_shape=_roi_infer,
          mesh_split=True,
          mesh_unsplit=lambda attrs, ndims: [(0, 0), (0, 2), (0, 3), (1, 1)])
def _roi_pooling(op_ctx, attrs, inputs, aux):
    ph, pw = attr_tuple(attrs["pooled_size"])
    return (_ROIPooling.apply(inputs[0], inputs[1], ph, pw, attr_float(
        attrs.get("spatial_scale", 1.0), 1.0)),)


# ---------------------------------------------------------------------------
# Correlation (ref: correlation-inl.h, FlowNet's displacement correlation)
# ---------------------------------------------------------------------------

def _corr_attrs(attrs):
    return (attr_int(attrs.get("kernel_size", 1), 1),
            attr_int(attrs.get("max_displacement", 1), 1),
            attr_int(attrs.get("stride1", 1), 1),
            attr_int(attrs.get("stride2", 1), 1),
            attr_int(attrs.get("pad_size", 0), 0),
            attr_bool(attrs.get("is_multiply", True), True))


def _corr_out(k, md, s1, pad, h, w):
    """Output rows and columns: ceil((padded - 2 * border) / stride1), in
    integers."""
    br = md + k // 2
    return (-((2 * br - h - 2 * pad) // s1), -((2 * br - w - 2 * pad) // s1))


def _corr_infer(attrs, in_shapes):
    k, md, s1, s2, pad, _ = _corr_attrs(attrs)
    d1, d2 = in_shapes
    if d1 is None:
        raise MXNetError("Correlation: data1 shape required")
    if d2 is not None and tuple(d2) != tuple(d1):
        raise MXNetError("Correlation: data2 %s differs from data1 %s"
                         % (tuple(d2), tuple(d1)))
    n, _, h, w = d1
    out_h, out_w = _corr_out(k, md, s1, pad, h, w)
    side = md // s2 * 2 + 1
    return [tuple(d1), tuple(d1)], [(n, side * side, out_h, out_w)], []


@register("Correlation", inputs=("data1", "data2"), infer_shape=_corr_infer,
          mesh_split=True,
          mesh_unsplit=lambda attrs, ndims: [(i, d) for i in (0, 1)
                                             for d in (1, 2, 3)])
def _correlation(op_ctx, attrs, inputs, aux):
    k, md, s1, s2, pad, mult = _corr_attrs(attrs)
    d1, d2 = inputs
    out_h, out_w = _corr_out(k, md, s1, pad, d1.shape[2], d1.shape[3])
    p1 = F.pad(d1, (pad,) * 4)
    p2 = F.pad(d2, (pad,) * 4)
    # the window of every output position: from md (border less the
    # kernel's radius) on, so no displacement of at most md leaves the map
    sh, sw = (out_h - 1) * s1 + k, (out_w - 1) * s1 + k
    a = p1[:, :, md:md + sh, md:md + sw]
    maps = []
    for dy in range(-md, md + 1, s2):
        for dx in range(-md, md + 1, s2):
            b = p2[:, :, md + dy:md + dy + sh, md + dx:md + dx + sw]
            m = (a * b if mult else torch.abs(a - b)).mean(1)
            if k > 1:
                # the k x k window sum; the reference divides by k*k*C
                m = F.avg_pool2d(m[:, None], k, stride=s1,
                                 divisor_override=1)[:, 0] / (k * k)
            else:
                m = m[:, ::s1, ::s1]
            maps.append(m)
    return (torch.stack(maps, dim=1),)
