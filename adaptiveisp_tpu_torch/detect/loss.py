"""YOLO detection loss: per image (the RL reward) and over a batch (detector
training); port of ``adaptiveisp_tpu/detect/loss.py``.

Targets are padded to a fixed [N, T_max, 5] (cls, xywh normalised) with a
validity mask.  Assignment is a static candidate table [5 offsets x na
anchors x T_max] per image and level with a validity mask, gathered and
masked-reduced as batched tensor code over the N images (the JAX package's
per-image ``vmap``).  Semantics, as the JAX package's:

  * anchor-ratio filter max(r, 1/r) < anchor_t;
  * +-0.5-cell neighbour offsets with j/k/l/m gating;
  * grid indices clamped, feeding both the gather and the box target;
  * CIoU box loss, BCE objectness with per-level balance [4, 1, .4], BCE
    classes with cp/cn label smoothing, mean reductions, bs = 1 per image;
  * two boxes on one (cell, anchor) write objectness by max
    (``scatter_reduce`` "amax"), not torch's last write.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from adaptiveisp_tpu_torch.detect.boxes import bbox_ciou
from adaptiveisp_tpu_torch.obs.profile import count
from adaptiveisp_tpu_torch.ops.math import clip

BALANCE_3 = (4.0, 1.0, 0.4)
BALANCE_5 = (4.0, 1.0, 0.25, 0.06, 0.02)
OFFSETS = np.array(
    [[0.0, 0.0], [0.5, 0.0], [0.0, 0.5], [-0.5, 0.0], [0.0, -0.5]],
    np.float32)  # x, y


@dataclasses.dataclass(frozen=True)
class LossHyp:
    """Loss hyperparameters after trainer scaling (hyp.scratch-low values;
    obj scaled once by (512/640)^2 for the 512 px protocol)."""

    box: float = 0.05
    obj: float = 1.0 * (512 / 640) ** 2
    cls: float = 0.5
    cls_pw: float = 1.0
    obj_pw: float = 1.0
    anchor_t: float = 4.0
    fl_gamma: float = 0.0
    label_smoothing: float = 0.0

    @property
    def cp(self):
        return 1.0 - 0.5 * self.label_smoothing

    @property
    def cn(self):
        return 0.5 * self.label_smoothing


def bce_with_logits(logits, targets, pos_weight: float = 1.0):
    """Elementwise binary cross-entropy with logits (torch semantics)."""
    return -(pos_weight * targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits))


def focal_modulation(logits, targets, loss, gamma: float, alpha: float = 0.25):
    """TF-style focal loss wrapper."""
    pred_prob = torch.sigmoid(logits)
    p_t = targets * pred_prob + (1 - targets) * (1 - pred_prob)
    alpha_factor = targets * alpha + (1 - targets) * (1 - alpha)
    return loss * alpha_factor * (1.0 - p_t) ** gamma


def _candidate_table(shape, targets, tmask, anchors, hyp: LossHyp):
    """Target-assignment table of every (offset, anchor, target) triple with
    a validity mask, for N images at one level.

    shape (ny, nx, na); targets [N, T, 5]; tmask [N, T] bool; anchors
    [na, 2] in grid units.  Returns validf [N, 5, na, T], gi, gj, a (int64,
    [N, 5, na, T]), tbox [N, 5, na, T, 4], anc [N, 5, na, T, 2] and
    n_matched [N]."""
    ny, nx, na = shape
    n, t = targets.shape[:2]
    dev = targets.device
    count("host_read.upload.loss", 3)   # the grid, the anchors, the offsets
    grid = torch.tensor([nx, ny], dtype=torch.float32, device=dev)
    gxy = targets[..., 1:3] * grid                       # [N, T, 2]
    gwh = targets[..., 3:5] * grid
    anchors = torch.as_tensor(anchors, dtype=torch.float32, device=dev)

    r = clip(gwh, 1e-9)[:, None] / anchors[None, :, None, :]   # [N, na, T, 2]
    ratio = torch.maximum(r, 1.0 / r).amax(-1)
    match = (ratio < hyp.anchor_t) & tmask[:, None, :]        # [N, na, T]

    g = 0.5
    inv = grid - gxy
    jx = (gxy[..., 0] % 1 < g) & (gxy[..., 0] > 1)
    ky = (gxy[..., 1] % 1 < g) & (gxy[..., 1] > 1)
    lx = (inv[..., 0] % 1 < g) & (inv[..., 0] > 1)
    my = (inv[..., 1] % 1 < g) & (inv[..., 1] > 1)
    off_valid = torch.stack([torch.ones_like(jx), jx, ky, lx, my], dim=1)

    validf = (off_valid[:, :, None, :] & match[:, None]).to(torch.float32)
    n_matched = validf.sum(dim=(1, 2, 3))

    offsets = torch.as_tensor(OFFSETS, device=dev)
    gij = torch.floor(gxy[:, None] - offsets[None, :, None, :])  # [N,5,T,2]
    gi = gij[..., 0].long().clamp(0, nx - 1)
    gj = gij[..., 1].long().clamp(0, ny - 1)
    tbox_xy = gxy[:, None] - torch.stack([gi, gj], dim=-1).float()

    full = (n, 5, na, t)
    gi_b = gi[:, :, None, :].expand(full)
    gj_b = gj[:, :, None, :].expand(full)
    a_b = torch.arange(na, device=dev)[None, None, :, None].expand(full)
    tbox = torch.cat([tbox_xy[:, :, None].expand(*full, 2),
                      gwh[:, None, None].expand(*full, 2)], dim=-1)
    anc = anchors[None, None, :, None, :].expand(*full, 2)
    return validf, gi_b, gj_b, a_b, tbox, anc, n_matched


def _level_terms(pred, targets, tmask, anchors, hyp: LossHyp):
    """Masked loss terms of N images at one detection level.

    pred [N, ny, nx, na, no]; targets [N, T, 5]; tmask [N, T].  Returns
    per image (box_err_sum, n_matched, obj_bce_mean, cls_bce_sum,
    n_cls_rows), each [N]."""
    n, ny, nx, na, no = pred.shape
    nc = no - 5
    validf, gi, gj, a, tbox, anc, n_matched = _candidate_table(
        (ny, nx, na), targets, tmask, anchors, hyp)

    b = torch.arange(n, device=pred.device)[:, None, None, None]
    p = pred[b, gj, gi, a]                                # [N, 5, na, T, no]
    pxy = torch.sigmoid(p[..., 0:2]) * 2 - 0.5
    pwh = (torch.sigmoid(p[..., 2:4]) * 2) ** 2 * anc
    iou = bbox_ciou(torch.cat([pxy, pwh], dim=-1), tbox)  # [N, 5, na, T]
    box_err_sum = ((1.0 - iou) * validf).sum(dim=(1, 2, 3))

    # objectness target: max of the candidates' IoU per (image, cell, anchor)
    iou_d = clip(iou.detach(), 0.0) * validf
    flat = ((b * ny + gj) * nx + gi) * na + a
    tobj = torch.zeros(n * ny * nx * na, dtype=torch.float32,
                       device=pred.device).scatter_reduce(
        0, flat.reshape(-1), iou_d.reshape(-1), "amax")
    tobj = tobj.reshape(n, ny, nx, na)
    obj_bce = bce_with_logits(pred[..., 4], tobj, hyp.obj_pw)
    if hyp.fl_gamma > 0:
        obj_bce = focal_modulation(pred[..., 4], tobj, obj_bce, hyp.fl_gamma)
    obj_bce_mean = obj_bce.mean(dim=(1, 2, 3))

    if nc > 1:
        tcls = targets[..., 0].long()                     # [N, T]
        hit = tcls[..., None] == torch.arange(nc, device=pred.device)
        t = torch.where(hit[:, None, None], hyp.cp, hyp.cn).expand(
            n, 5, na, -1, nc)
        cls_bce = bce_with_logits(p[..., 5:], t, hyp.cls_pw)
        if hyp.fl_gamma > 0:
            cls_bce = focal_modulation(p[..., 5:], t, cls_bce, hyp.fl_gamma)
        cls_sum = (cls_bce * validf[..., None]).sum(dim=(1, 2, 3, 4))
    else:
        cls_sum = torch.zeros(n, device=pred.device)
    return box_err_sum, n_matched, obj_bce_mean, cls_sum, n_matched * nc


def per_image_loss_batch(preds: Sequence[torch.Tensor], targets, tmask,
                         anchors_grid: Sequence, hyp: LossHyp):
    """The detector loss of each image on its own (bs = 1), the reward.

    preds: per-level [N, ny, nx, na, no]; targets [N, T, 5]; tmask [N, T].
    Returns (total [N, 1], {"box", "obj", "cls"} each [N]); total =
    lbox + lobj + lcls scaled by the hyp gains."""
    balance = BALANCE_3 if len(preds) == 3 else BALANCE_5
    tmask = tmask.to(torch.bool)
    lbox = lobj = lcls = 0.0
    for i, pred in enumerate(preds):
        box_sum, n, obj_mean, cls_sum, n_cls = _level_terms(
            pred, targets, tmask, anchors_grid[i], hyp)
        has = (n > 0).to(torch.float32)
        lbox = lbox + has * box_sum / torch.clamp(n, min=1.0)
        lcls = lcls + has * cls_sum / torch.clamp(n_cls, min=1.0)
        lobj = lobj + obj_mean * balance[i]
    lbox, lobj, lcls = lbox * hyp.box, lobj * hyp.obj, lcls * hyp.cls
    return (lbox + lobj + lcls)[:, None], {"box": lbox, "obj": lobj,
                                           "cls": lcls}


def batch_loss(preds: Sequence[torch.Tensor], targets, tmask,
               anchors_grid: Sequence, hyp: LossHyp, mesh=None):
    """ComputeLoss semantics over a batch: each level's box and class terms
    are averaged over the batch's matched candidates, objectness over the
    batch's cells, with the level balance (``BALANCE_3`` / ``BALANCE_5``).

    preds: per-level [N, ny, nx, na, no]; targets [N, T, 5]; tmask [N, T].
    Returns ((lbox + lobj + lcls) * N, components [3] detached).

    mesh (a data mesh of more than one rank, each holding its rows of the
    batch): the rank's term of the global batch's loss.  The matched
    counts and N are the global batch's (one all-reduce of the counts), so
    the ranks' terms and their gradients sum to the single-device loss and
    gradient on the global batch."""
    balance = BALANCE_3 if len(preds) == 3 else BALANCE_5
    bs = preds[0].shape[0]
    tmask = tmask.to(torch.bool)
    terms = [_level_terms(pred, targets, tmask, anchors_grid[i], hyp)
             for i, pred in enumerate(preds)]
    counts = torch.stack([t[1].sum() for t in terms]
                         + [t[4].sum() for t in terms])
    sharded = mesh is not None and mesh.data_size > 1
    if sharded:
        from adaptiveisp_tpu_torch.parallel import all_reduce

        counts = all_reduce(mesh, counts)
        bs = bs * mesh.data_size
    nl = len(preds)
    lbox = lobj = lcls = 0.0
    for i, (box_sums, _, obj_means, cls_sums, _) in enumerate(terms):
        n_tot, n_cls = counts[i], counts[nl + i]
        has = (n_tot > 0).to(torch.float32)
        lbox = lbox + has * box_sums.sum() / torch.clamp(n_tot, min=1.0)
        lcls = lcls + has * cls_sums.sum() / torch.clamp(n_cls, min=1.0)
        obj = obj_means.sum() / bs if sharded else obj_means.mean()
        lobj = lobj + obj * balance[i]
    lbox, lobj, lcls = lbox * hyp.box, lobj * hyp.obj, lcls * hyp.cls
    comps = torch.stack([lbox, lobj, lcls]).detach()
    return (lbox + lobj + lcls) * bs, comps


def per_image_loss(preds: Sequence[torch.Tensor], targets, tmask,
                   anchors_grid: Sequence, hyp: LossHyp
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`per_image_loss_batch` for ONE image: preds per-level
    [ny, nx, na, no], targets [T, 5], tmask [T] -> (scalar total,
    components)."""
    total, comps = per_image_loss_batch(
        [p[None] for p in preds], targets[None], tmask[None], anchors_grid,
        hyp)
    return total[0, 0], {k: v[0] for k, v in comps.items()}


def pad_targets(label_list: List, t_max: int) -> Tuple:
    """Host-side padding of variable-length labels to [N, T_max, 5] + mask.

    Each element of label_list is an [ni, 6] array (img-idx, cls, xywh) or
    [ni, 5] (cls, xywh); the image-index column is dropped."""
    n = len(label_list)
    out = np.zeros((n, t_max, 5), np.float32)
    mask = np.zeros((n, t_max), bool)
    for i, lab in enumerate(label_list):
        lab = np.asarray(lab, np.float32)
        if lab.size == 0:
            continue
        if lab.shape[1] == 6:
            lab = lab[:, 1:]
        k = min(lab.shape[0], t_max)
        out[i, :k] = lab[:k]
        mask[i, :k] = True
    return out, mask
