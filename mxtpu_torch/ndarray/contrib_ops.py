"""Detection and other contrib ops: the port of
``mxtpu/ndarray/contrib_ops.py`` (reference ``src/operator/contrib/``:
bounding boxes, NMS, multibox anchors, targets and detection,
ROIAlign/ROIPooling, adaptive pooling, boolean mask), registered in the
shared ``OP_REGISTRY`` with their ``_contrib_*`` aliases.

Shapes are static as in the reference: ``box_nms`` returns the
fixed-size, score-sorted array with suppressed rows' scores at -1 (the
reference's contract), its greedy suppression one step per row.
``boolean_mask`` has a data-dependent shape and reads its mask on the
host. Anchors (``MultiBoxPrior``) depend on shapes alone: they are made
on the host in float64 and handed over in float32.
"""
from __future__ import annotations

import numpy as onp
import torch

from .ndarray import NDArray, apply_op
from .ops import register_op

__all__ = ["box_iou", "box_nms", "bipartite_matching", "MultiBoxPrior",
           "MultiBoxTarget", "MultiBoxDetection", "ROIAlign", "ROIPooling",
           "AdaptiveAvgPooling2D", "boolean_mask", "allclose",
           "arange_like", "index_copy"]


def _corner_iou(a, b):
    """IoU between (..., N, 4) and (..., M, 4) corner boxes."""
    ax1, ay1, ax2, ay2 = a.unbind(-1)
    bx1, by1, bx2, by2 = b.unbind(-1)
    ix1 = torch.maximum(ax1[..., :, None], bx1[..., None, :])
    iy1 = torch.maximum(ay1[..., :, None], by1[..., None, :])
    ix2 = torch.minimum(ax2[..., :, None], bx2[..., None, :])
    iy2 = torch.minimum(ay2[..., :, None], by2[..., None, :])
    iw = torch.clamp(ix2 - ix1, min=0)
    ih = torch.clamp(iy2 - iy1, min=0)
    inter = iw * ih
    area_a = torch.clamp((ax2 - ax1) * (ay2 - ay1), min=0)
    area_b = torch.clamp((bx2 - bx1) * (by2 - by1), min=0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / torch.where(union > 0, union, 1),
                       torch.zeros((), dtype=inter.dtype,
                                   device=inter.device))


def _center_to_corner(t):
    cx, cy, w, h = t.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


@register_op("box_iou", aliases=("_contrib_box_iou",))
def box_iou(lhs, rhs, format="corner", **kwargs):
    """Pairwise IoU (reference _contrib_box_iou); 'corner' (x1,y1,x2,y2)
    or 'center' (cx,cy,w,h)."""
    def _f(a, b):
        if format == "center":
            a, b = _center_to_corner(a), _center_to_corner(b)
        return _corner_iou(a, b)
    return apply_op(_f, [lhs, rhs], "box_iou")


def _greedy_keep(iou, valid, overlap_thresh):
    """The reference's suppression loop: row i, when kept, suppresses
    every later row whose IoU with it exceeds the threshold."""
    n = iou.shape[1]
    over = (iou > overlap_thresh) & torch.ones(
        (n, n), dtype=torch.bool, device=iou.device).triu(1)
    keep = valid.clone()
    for i in range(n):
        keep &= ~(over[:, i, :] & keep[:, i:i + 1])
    return keep


@register_op("box_nms", aliases=("_contrib_box_nms",))
def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, force_suppress=False,
            in_format="corner", out_format="corner", **kwargs):
    """Non-maximum suppression (reference _contrib_box_nms): rows are
    [id, score, x1, y1, x2, y2, ...]; output is score-sorted with
    suppressed/invalid rows' score set to -1."""
    def _f(x):
        batched = x.dim() == 3
        if not batched:
            x = x[None]
        B, N, K = x.shape
        scores = x[..., score_index]
        boxes = x[..., coord_start:coord_start + 4]
        if in_format == "center":
            boxes = _center_to_corner(boxes)
        order = torch.argsort(-scores, dim=1, stable=True)
        xs = torch.take_along_dim(x, order[..., None], dim=1)
        scores_s = torch.take_along_dim(scores, order, dim=1)
        boxes_s = torch.take_along_dim(boxes, order[..., None], dim=1)
        with torch.no_grad():
            iou = _corner_iou(boxes_s, boxes_s)          # (B, N, N)
            valid = scores_s > valid_thresh
            if topk > 0:
                valid = valid & (torch.arange(N, device=x.device)[None, :]
                                 < topk)
            if id_index >= 0 and not force_suppress:
                ids_s = torch.take_along_dim(x[..., id_index], order, dim=1)
                same_cls = ids_s[..., :, None] == ids_s[..., None, :]
                iou = torch.where(same_cls, iou, torch.zeros_like(iou))
            keep = _greedy_keep(iou, valid, overlap_thresh)
        new_scores = torch.where(keep, scores_s,
                                 torch.full_like(scores_s, -1.0))
        cols = list(xs.unbind(-1))
        cols[score_index % K] = new_scores
        out = torch.stack(cols, dim=-1)
        if out_format != in_format:
            bsel = out[..., coord_start:coord_start + 4]
            if out_format == "corner":      # center → corner
                conv = _center_to_corner(bsel)
            else:                           # corner → center
                x1, y1, x2, y2 = bsel.unbind(-1)
                conv = torch.stack([(x1 + x2) / 2, (y1 + y2) / 2,
                                    x2 - x1, y2 - y1], dim=-1)
            out = torch.cat([out[..., :coord_start], conv,
                             out[..., coord_start + 4:]], dim=-1)
        return out if batched else out[0]
    return apply_op(_f, [data], "box_nms")


@register_op("bipartite_matching", aliases=("_contrib_bipartite_matching",))
def bipartite_matching(data, threshold=0.5, is_ascend=False, topk=-1,
                       **kwargs):
    """Greedy bipartite matching over a score matrix (reference
    _contrib_bipartite_matching): returns (row→col match or -1,
    col→row match or -1)."""
    def _f(x):
        batched = x.dim() == 3
        if not batched:
            x = x[None]
        B, N, M = x.shape
        sgn = 1.0 if is_ascend else -1.0
        rmatch = torch.full((B, N), -1.0, dtype=x.dtype, device=x.device)
        cmatch = torch.full((B, M), -1.0, dtype=x.dtype, device=x.device)
        rows = torch.arange(N, device=x.device)
        cols = torch.arange(M, device=x.device)
        mat = x
        iters = min(N, M) if topk <= 0 else min(topk, min(N, M))
        for _ in range(iters):
            idx = torch.argmin((sgn * mat).reshape(B, -1), dim=1)
            val = torch.take_along_dim(mat.reshape(B, -1), idx[:, None],
                                       dim=1)[:, 0]
            r, c = idx // M, idx % M
            ok = (val > threshold) if not is_ascend else (val < threshold)
            ok = ok & (torch.take_along_dim(rmatch, r[:, None], dim=1)[:, 0]
                       < 0)
            rmatch = torch.where(ok[:, None] & (rows[None] == r[:, None]),
                                 c[:, None].to(rmatch.dtype), rmatch)
            cmatch = torch.where(ok[:, None] & (cols[None] == c[:, None]),
                                 r[:, None].to(cmatch.dtype), cmatch)
            # a matched row and column become +big under sgn, so argmin
            # never visits them again
            mat = torch.where((rows[None, :, None] == r[:, None, None]) |
                              (cols[None, None, :] == c[:, None, None]),
                              torch.full((), sgn * 1e30, dtype=x.dtype,
                                         device=x.device), mat)
        if not batched:
            return rmatch[0], cmatch[0]
        return rmatch, cmatch
    return apply_op(_f, [data], "bipartite_matching", n_out=2)


@register_op("MultiBoxPrior", aliases=("_contrib_MultiBoxPrior",))
def MultiBoxPrior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                  steps=(-1.0, -1.0), offsets=(0.5, 0.5), **kwargs):
    """SSD anchor generation (reference multibox_prior.cc): for an
    (B, C, H, W) feature map emits (1, H*W*(S+R-1), 4) corner anchors."""
    sizes = tuple(float(s) for s in sizes)
    ratios = tuple(float(r) for r in ratios)
    H, W = data.shape[2], data.shape[3]
    step_y = steps[0] if steps[0] > 0 else 1.0 / H
    step_x = steps[1] if steps[1] > 0 else 1.0 / W
    cy = (onp.arange(H) + offsets[0]) * step_y
    cx = (onp.arange(W) + offsets[1]) * step_x
    cyx = onp.stack(onp.meshgrid(cy, cx, indexing="ij"),
                    axis=-1).reshape(-1, 2)          # (H*W, [y, x])
    # reference order: (s_i, r_0) for all sizes, then (s_0, r_j) j>0
    whs = [(s * onp.sqrt(ratios[0]), s / onp.sqrt(ratios[0]))
           for s in sizes] + \
          [(sizes[0] * onp.sqrt(r), sizes[0] / onp.sqrt(r))
           for r in ratios[1:]]
    anchors = [onp.concatenate([cyx[:, 1:2] - w / 2, cyx[:, 0:1] - h / 2,
                                cyx[:, 1:2] + w / 2, cyx[:, 0:1] + h / 2],
                               axis=1) for w, h in whs]
    out = onp.stack(anchors, axis=1).reshape(-1, 4)
    if clip:
        out = onp.clip(out, 0.0, 1.0)
    anchors = torch.from_numpy(out[None].astype(onp.float32))
    return apply_op(lambda x: anchors.to(x.device), [data], "MultiBoxPrior")


def _bilinear_taps(feat, bidx, ys, xs):
    """The four bilinear taps of every (roi, y, x) sample, as
    (R, Y, X, C) each, and their weights."""
    B, C, H, W = feat.shape
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, H - 1)
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, W - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    wy = torch.clamp(ys - y0, 0, 1)[:, :, None, None]
    wx = torch.clamp(xs - x0, 0, 1)[:, None, :, None]
    b = bidx[:, None, None]
    taps = [feat[b, :, yy[:, :, None], xx[:, None, :]]
            for yy, xx in ((y0, x0), (y0, x1), (y1, x0), (y1, x1))]
    return taps, wy, wx


@register_op("ROIAlign", aliases=("_contrib_ROIAlign",))
def ROIAlign(data, rois, pooled_size=(7, 7), spatial_scale=1.0,
             sample_ratio=2, position_sensitive=False, **kwargs):
    """ROI Align (reference roi_align.cc): bilinear sampling on a
    (B, C, H, W) feature map for rois (R, 5) = [batch_idx, x1, y1, x2,
    y2]."""
    ph, pw = pooled_size
    sr = max(int(sample_ratio), 1)

    def _f(feat, r):
        B, C, H, W = feat.shape
        R = r.shape[0]
        bidx = r[:, 0].to(torch.int64)
        x1, y1, x2, y2 = [r[:, i] * spatial_scale for i in range(1, 5)]
        rw = torch.clamp(x2 - x1, min=1e-6)
        rh = torch.clamp(y2 - y1, min=1e-6)
        bin_w = rw / pw
        bin_h = rh / ph
        gy = (torch.arange(ph * sr, device=feat.device, dtype=r.dtype)
              + 0.5) / sr
        gx = (torch.arange(pw * sr, device=feat.device, dtype=r.dtype)
              + 0.5) / sr
        ys = y1[:, None] + gy[None, :] * bin_h[:, None]   # (R, ph*sr)
        xs = x1[:, None] + gx[None, :] * bin_w[:, None]
        (f00, f01, f10, f11), wy, wx = _bilinear_taps(feat, bidx, ys, xs)
        samples = (f00 * (1 - wy) * (1 - wx) + f01 * (1 - wy) * wx +
                   f10 * wy * (1 - wx) + f11 * wy * wx)  # (R, Y, X, C)
        samples = samples.permute(0, 3, 1, 2)
        return samples.reshape(R, C, ph, sr, pw, sr).mean(dim=(3, 5))
    return apply_op(_f, [data, rois], "ROIAlign")


@register_op("ROIPooling")
def ROIPooling(data, rois, pooled_size=(7, 7), spatial_scale=1.0, **kwargs):
    """Max ROI pooling (reference roi_pooling.cc) approximated by dense
    sampling + max (static shapes)."""
    ph, pw = pooled_size

    def _f(feat, r):
        B, C, H, W = feat.shape
        R = r.shape[0]
        bidx = r[:, 0].to(torch.int64)
        x1, y1, x2, y2 = [torch.round(r[:, i] * spatial_scale)
                          for i in range(1, 5)]
        rw = torch.clamp(x2 - x1 + 1, min=1.0)
        rh = torch.clamp(y2 - y1 + 1, min=1.0)
        sr = 4
        gy = (torch.arange(ph * sr, device=feat.device, dtype=r.dtype)
              + 0.5) / (ph * sr)
        gx = (torch.arange(pw * sr, device=feat.device, dtype=r.dtype)
              + 0.5) / (pw * sr)
        ys = y1[:, None] + gy[None, :] * rh[:, None]
        xs = x1[:, None] + gx[None, :] * rw[:, None]
        yi = torch.clamp(ys.to(torch.int64), 0, H - 1)
        xi = torch.clamp(xs.to(torch.int64), 0, W - 1)
        samples = feat[bidx[:, None, None], :, yi[:, :, None],
                       xi[:, None, :]].permute(0, 3, 1, 2)
        return samples.reshape(R, C, ph, sr, pw, sr).amax(dim=(3, 5))
    return apply_op(_f, [data, rois], "ROIPooling")


@register_op("AdaptiveAvgPooling2D",
             aliases=("_contrib_AdaptiveAvgPooling2D",))
def AdaptiveAvgPooling2D(data, output_size=1, **kwargs):
    """Adaptive average pooling (reference adaptive_avg_pooling.cc)."""
    if isinstance(output_size, int):
        oh = ow = output_size
    else:
        oh, ow = output_size

    def _f(x):
        B, C, H, W = x.shape
        # split H into oh (possibly uneven) bins like the reference
        ys = [(H * i) // oh for i in range(oh + 1)]
        xs_ = [(W * i) // ow for i in range(ow + 1)]
        rows = []
        for i in range(oh):
            cols = [x[:, :, ys[i]:ys[i + 1], xs_[j]:xs_[j + 1]]
                    .mean(dim=(2, 3)) for j in range(ow)]
            rows.append(torch.stack(cols, dim=-1))
        return torch.stack(rows, dim=-2)
    return apply_op(_f, [data], "AdaptiveAvgPooling2D")


def boolean_mask(data, index, axis: int = 0):
    """Select rows where index != 0 (reference _contrib_boolean_mask).
    The output's shape depends on the mask, which is read on the host."""
    mask = (index.asnumpy() if isinstance(index, NDArray)
            else onp.asarray(index)) != 0
    sel = torch.from_numpy(onp.nonzero(mask)[0])
    return apply_op(lambda x: torch.index_select(x, axis, sel.to(x.device)),
                    [data], "boolean_mask")


@register_op("allclose", aliases=("_contrib_allclose",))
def allclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=False, **kwargs):
    return apply_op(
        lambda x, y: torch.isclose(x, y, rtol=rtol, atol=atol,
                                   equal_nan=equal_nan).all()
        .to(torch.float32), [a, b], "allclose")


@register_op("arange_like", aliases=("_contrib_arange_like",))
def arange_like(data, start=0.0, step=1.0, repeat=1, axis=None, **kwargs):
    def _f(x):
        n = x.numel() if axis is None else x.shape[axis]
        # reference semantics: output length stays n; with repeat each
        # value appears `repeat` times within it
        count = -(-n // repeat)
        out = torch.arange(count, dtype=torch.float32,
                           device=x.device) * step + start
        if repeat > 1:
            out = torch.repeat_interleave(out, repeat)[:n]
        if axis is None:
            out = out.reshape(x.shape)
        return out
    return apply_op(_f, [data], "arange_like")


@register_op("index_copy", aliases=("_contrib_index_copy",))
def index_copy(old, index, new_tensor, **kwargs):
    def _f(o, idx, n):
        return torch.index_copy(o, 0, idx.to(torch.int64), n.to(o.dtype))
    return apply_op(_f, [old, index, new_tensor], "index_copy")


# -- MultiBox target/detection (SSD training/decoding) ----------------------
def _anchor_geometry(anc2):
    aw = anc2[:, 2] - anc2[:, 0]
    ah = anc2[:, 3] - anc2[:, 1]
    acx = (anc2[:, 0] + anc2[:, 2]) / 2
    acy = (anc2[:, 1] + anc2[:, 3]) / 2
    return aw, ah, acx, acy


@register_op("MultiBoxTarget", aliases=("_contrib_MultiBoxTarget",))
def MultiBoxTarget(anchor, label, cls_pred, overlap_threshold=0.5,
                   ignore_label=-1, negative_mining_ratio=-1,
                   negative_mining_thresh=0.5,
                   variances=(0.1, 0.1, 0.2, 0.2), **kwargs):
    """SSD training targets (reference multibox_target.cc): per-anchor
    box regression targets + mask + class targets from ground truth
    ``label`` (B, M, 5) = [cls, x1, y1, x2, y2] (cls = -1 padding)."""
    v = variances

    def _f(anc, lab, pred):
        anc2 = anc.reshape(-1, 4)
        A = anc2.shape[0]
        B, M, _ = lab.shape
        gt_boxes = lab[..., 1:5]
        gt_cls = lab[..., 0]
        valid_gt = gt_cls >= 0
        iou = _corner_iou(anc2[None], gt_boxes)      # (B, A, M)
        iou = torch.where(valid_gt[:, None, :], iou,
                          torch.full_like(iou, -1.0))
        best_gt = torch.argmax(iou, dim=2)           # (B, A)
        best_iou = torch.amax(iou, dim=2)
        pos = best_iou >= overlap_threshold
        # each gt's best anchor is positive too; padded gts all argmax to
        # anchor 0, so their flags are added, never written
        best_anchor = torch.argmax(iou, dim=1)       # (B, M)
        force = torch.zeros((B, A), dtype=torch.int32, device=anc.device) \
            .scatter_add_(1, best_anchor, valid_gt.to(torch.int32)) > 0
        pos = pos | force
        matched = torch.take_along_dim(gt_boxes, best_gt[..., None], dim=1)
        # encode: (gt_center - anc_center)/anc_wh/var, log(gt_wh/anc_wh)/var
        aw, ah, acx, acy = _anchor_geometry(anc2)
        gw = torch.clamp(matched[..., 2] - matched[..., 0], min=1e-8)
        gh = torch.clamp(matched[..., 3] - matched[..., 1], min=1e-8)
        gcx = (matched[..., 0] + matched[..., 2]) / 2
        gcy = (matched[..., 1] + matched[..., 3]) / 2
        tx = (gcx - acx[None]) / (aw[None] * v[0])
        ty = (gcy - acy[None]) / (ah[None] * v[1])
        tw = torch.log(gw / aw[None]) / v[2]
        th = torch.log(gh / ah[None]) / v[3]
        loc_t = torch.stack([tx, ty, tw, th], dim=-1)
        loc_t = torch.where(pos[..., None], loc_t,
                            torch.zeros_like(loc_t)).reshape(B, -1)
        loc_mask = pos.to(lab.dtype)[..., None].expand(B, A, 4) \
            .reshape(B, -1)
        matched_cls = torch.take_along_dim(gt_cls, best_gt, dim=1)
        zero = torch.zeros_like(matched_cls)
        cls_t = torch.where(pos, matched_cls + 1, zero)   # 0 = background
        if negative_mining_ratio > 0:
            # hard-negative mining (reference): keep the
            # ratio*num_pos hardest negatives as background targets,
            # mark the rest ignore_label. Hardness = max foreground
            # probability predicted for a negative anchor.
            probs = torch.softmax(pred, dim=1)
            hardness = torch.amax(probs[:, 1:, :], dim=1)    # (B, A)
            neg = (~pos) & (best_iou < negative_mining_thresh)
            hardness = torch.where(neg, hardness,
                                   torch.full_like(hardness, -1.0))
            order = torch.argsort(-hardness, dim=1, stable=True)
            rank = torch.argsort(order, dim=1, stable=True)
            num_pos = pos.sum(dim=1, keepdim=True)
            keep_neg = neg & (rank < negative_mining_ratio * num_pos)
            cls_t = torch.where(pos, cls_t, torch.where(
                keep_neg, zero, torch.full_like(zero, float(ignore_label))))
        return loc_t, loc_mask, cls_t
    return apply_op(_f, [anchor, label, cls_pred], "MultiBoxTarget",
                    n_out=3)


@register_op("MultiBoxDetection", aliases=("_contrib_MultiBoxDetection",))
def MultiBoxDetection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                      nms_threshold=0.5, force_suppress=False,
                      variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1, **kwargs):
    """SSD decode + NMS (reference multibox_detection.cc):
    cls_prob (B, num_cls+1, A), loc_pred (B, A*4), anchors (1, A, 4) →
    (B, A, 6) rows [cls_id, score, x1, y1, x2, y2], suppressed = -1."""
    v = variances

    def _f(cp, lp, anc):
        B, _, A = cp.shape
        aw, ah, acx, acy = _anchor_geometry(anc.reshape(-1, 4))
        loc = lp.reshape(B, A, 4)
        cx = loc[..., 0] * v[0] * aw + acx
        cy = loc[..., 1] * v[1] * ah + acy
        w = torch.exp(loc[..., 2] * v[2]) * aw
        h = torch.exp(loc[..., 3] * v[3]) * ah
        boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2,
                             cy + h / 2], dim=-1)
        if clip:
            boxes = torch.clamp(boxes, 0.0, 1.0)
        scores = cp[:, 1:, :]                        # skip background
        cls_id = torch.argmax(scores, dim=1).to(cp.dtype)
        score = torch.amax(scores, dim=1)
        keep = score > threshold
        none = torch.full_like(score, -1.0)
        return torch.cat([torch.where(keep, cls_id, none)[..., None],
                          torch.where(keep, score, none)[..., None],
                          boxes], dim=-1)
    decoded = apply_op(_f, [cls_prob, loc_pred, anchor], "MultiBoxDecode")
    return box_nms(decoded, overlap_thresh=nms_threshold, valid_thresh=0,
                   topk=nms_topk, coord_start=2, score_index=1, id_index=0,
                   force_suppress=force_suppress)
