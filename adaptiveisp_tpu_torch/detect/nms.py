"""Fixed-shape non-maximum suppression as tensor ops (port of
``adaptiveisp_tpu/detect/nms.py``; there is no torchvision here).

Same semantics and defaults as the JAX version, batched over images:
  * candidates are gated by objectness > conf_thres with a mask;
  * multi-label expands every (box, class) pair; the top ``max_nms`` by score
    are kept, equal scores going to the lower index (a stable sort; the JAX
    version's top-k leaves their order unspecified);
  * boxes are offset by class * MAX_WH so classes never overlap;
  * blocked greedy suppression: score-sorted rows in blocks of ``block``;
    each block is resolved by a Jacobi fixpoint (exactly greedy, since the
    suppression graph only points to earlier rows), then its kept boxes
    suppress every later row.  An image stops once ``max_det`` boxes are
    kept; later blocks score lower and can never reach its output;
  * each block runs in a span ``nms.block``; every host read of a flag
    (a block's "any image still short of ``max_det``", a fixpoint round's
    "anything changed") is counted as ``host_read.nms``;
  * ``merge=True`` (merge-NMS) replaces each kept box by the score-weighted
    mean of the candidates overlapping it.

Returns padded [N, max_det, 6] (xyxy, conf, cls) and a count per image;
with ``nm`` mask coefficients, also their rows [N, max_det, nm].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from adaptiveisp_tpu_torch.detect.boxes import box_iou, xywh2xyxy
from adaptiveisp_tpu_torch.obs.profile import count, span

MAX_WH = 7680.0


def _top_k(scores, k: int):
    """Exact top-k along the last dim, ties to the lower index."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _any(flags) -> bool:
    """A host read: whether any of the device's ``flags`` is set."""
    count("host_read.nms")
    return bool(flags.any())


def _take(x, idx):
    """x [N, B, ...] gathered at idx [N, k] along dim 1."""
    return torch.gather(x, 1, idx.reshape(
        idx.shape + (1,) * (x.dim() - 2)).expand(
        idx.shape + x.shape[2:]))


@torch.no_grad()
def non_max_suppression(prediction, conf_thres: float = 0.25,
                        iou_thres: float = 0.45, max_det: int = 300,
                        max_nms: int = 4096, multi_label: bool = False,
                        agnostic: bool = False, block: int = 512,
                        nm: int = 0, merge: bool = False, classes=None):
    """prediction: [N, n_boxes, 5 + nc (+ nm)] decoded (xywh, obj, class
    probs, and with nm > 0 the raw mask coefficients of a segmentation
    head).

    ``block``: rows per greedy block (the result does not depend on it;
    a smaller block stops earlier once ``max_det`` boxes are kept).
    ``classes`` (sequence of class ids) keeps only those classes: in the
    multi-label path disallowed pairs score 0; in the single-label path a
    row whose best class is filtered is dropped.
    ``merge``: each kept box becomes the score-weighted mean of every valid
    candidate overlapping it above ``iou_thres`` (in class-offset space),
    kept boxes that overlap nothing but themselves are dropped, and the
    survivors are compacted in score order; an image merges only when it
    has 1 < candidates < 3000 (the reference's cost guard, kept for
    parity).
    Returns (detections [N, max_det, 6], n_valid [N] int32); with nm > 0
    a third output holds each kept detection's mask coefficients
    [N, max_det, nm] (zero on padding rows).
    """
    n_img, n_box, no = prediction.shape
    nc = no - 5 - nm
    extra = prediction[..., 5 + nc:]
    prediction = prediction[..., :5 + nc]
    dev = prediction.device
    obj = prediction[..., 4]
    cand = obj > conf_thres
    box = xywh2xyxy(prediction[..., :4])
    cls_conf = prediction[..., 5:] * obj[..., None]
    cmask = None
    if classes is not None:
        cmask = torch.zeros((nc,), dtype=prediction.dtype, device=dev)
        count("host_read.upload.nms")
        cmask[torch.as_tensor(list(classes), dtype=torch.long)] = 1.0

    if multi_label and nc > 1:
        if cmask is not None:
            cls_conf = cls_conf * cmask
        scores = torch.where(cand[..., None], cls_conf,
                             torch.zeros_like(cls_conf)).reshape(n_img, -1)
        k = min(max_nms, scores.shape[1])
        top_scores, top_i = _top_k(scores, k)
        top_boxes = _take(box, top_i // nc)
        top_cls = (top_i % nc).to(prediction.dtype)
        top_extra = _take(extra, top_i // nc)
    else:
        best_cls = torch.argmax(cls_conf, dim=-1)
        scores = torch.gather(cls_conf, 2, best_cls[..., None])[..., 0]
        scores = torch.where(cand, scores, torch.zeros_like(scores))
        if cmask is not None:
            scores = scores * cmask[best_cls]
        k = min(max_nms, scores.shape[1])
        top_scores, top_i = _top_k(scores, k)
        top_boxes = _take(box, top_i)
        top_cls = torch.gather(best_cls, 1, top_i).to(prediction.dtype)
        top_extra = _take(extra, top_i)
    top_valid = top_scores > conf_thres

    offset = torch.zeros_like(top_cls) if agnostic else top_cls * MAX_WH
    off_boxes = top_boxes + offset[..., None]

    # ---- blocked greedy suppression over score-sorted rows ----
    bsz = min(block, k)
    nb = -(-k // bsz)
    kp = nb * bsz
    boxes_p = F.pad(off_boxes, (0, 0, 0, kp - k))
    alive = F.pad(top_valid, (0, kp - k))
    col_k = torch.arange(kp, device=dev)
    r = torch.arange(bsz, device=dev)
    lower = r[None, :] < r[:, None]  # [row, col]: col precedes row
    n_kept = torch.zeros((n_img,), dtype=torch.long, device=dev)
    it_end = torch.zeros((n_img,), dtype=torch.long, device=dev)
    for it in range(nb):
        with span("nms.block"):
            active = n_kept < max_det
            if not _any(active):
                break
            start = it * bsz
            blk_boxes = boxes_p[:, start:start + bsz]
            blk_alive = alive[:, start:start + bsz]
            sup_edge = (box_iou(blk_boxes, blk_boxes) > iou_thres) & lower
            kb, prev, i = blk_alive, torch.zeros_like(blk_alive), 0
            while i < bsz and _any(kb != prev):
                suppressed = (sup_edge & kb[:, None, :]).any(dim=2)
                prev, kb, i = kb, blk_alive & ~suppressed, i + 1
            sup = ((box_iou(blk_boxes, boxes_p) > iou_thres)
                   & kb[..., None]).any(dim=1)
            new_alive = alive & ~(sup & (col_k >= start + bsz))
            new_alive[:, start:start + bsz] = kb
            alive = torch.where(active[:, None], new_alive, alive)
            n_kept = n_kept + torch.where(active, kb.sum(dim=1),
                                          torch.zeros_like(n_kept))
            it_end = torch.where(active, torch.full_like(it_end, it + 1),
                                 it_end)
    keep = (alive & (col_k[None, :] < it_end[:, None] * bsz))[:, :k]

    # survivors by score (already sorted), padded to max_det
    keep_scores = torch.where(keep, top_scores,
                              torch.full_like(top_scores, -1.0))
    kd = min(max_det, k)
    sel_scores, sel = _top_k(keep_scores, kd)
    if kd < max_det:
        sel_scores = F.pad(sel_scores, (0, max_det - kd), value=-1.0)
        sel = F.pad(sel, (0, max_det - kd))
    det_valid = sel_scores > conf_thres
    out_boxes = _take(top_boxes, sel)
    if merge:
        n_cand = top_valid.sum(dim=1)
        overlap = ((box_iou(_take(off_boxes, sel), off_boxes) > iou_thres)
                   & top_valid[:, None, :])                 # [N, max_det, k]
        w = overlap * top_scores[:, None, :]
        merged = (w @ top_boxes) / torch.clamp(w.sum(2, keepdim=True),
                                               min=1e-12)
        apply = ((n_cand > 1) & (n_cand < 3000))[:, None]
        out_boxes = torch.where(apply[..., None], merged, out_boxes)
        det_valid = det_valid & (~apply | (overlap.sum(2) > 1))
        # re-compact: drop the rows merging dropped, keep score order
        sel_scores, re_idx = _top_k(torch.where(
            det_valid, sel_scores, torch.full_like(sel_scores, -1.0)),
            max_det)
        out_boxes = _take(out_boxes, re_idx)
        sel = torch.gather(sel, 1, re_idx)
        det_valid = sel_scores > conf_thres
    out = torch.cat([
        out_boxes,
        torch.where(det_valid, sel_scores,
                    torch.zeros_like(sel_scores))[..., None],
        torch.gather(top_cls, 1, sel)[..., None],
    ], dim=-1)
    out = torch.where(det_valid[..., None], out, torch.zeros_like(out))
    n_valid = det_valid.sum(dim=1, dtype=torch.int32)
    if nm:
        out_extra = _take(top_extra, sel)
        out_extra = torch.where(det_valid[..., None], out_extra,
                                torch.zeros_like(out_extra))
        return out, n_valid, out_extra
    return out, n_valid
