"""Instance segmentation: mask helpers, the mask loss, the train step, the
validator, ``SegmentTrainer`` and the two CLIs (port of
``adaptiveisp_tpu/detect/segment.py``).

    python -m adaptiveisp_tpu_torch.detect.segment --source DIR [--save_dir D]
    python -m adaptiveisp_tpu_torch.detect.segment train --data IMAGES ...

Mask pipeline: raw coefficients [n, nm] from NMS @ prototype masks
[mh, mw, nm] -> sigmoid -> crop to the (downsampled) predicted box ->
bilinear upsample to the network input size -> threshold 0.5.

Resizes follow ``jax.image.resize`` (:func:`resize`): half-pixel centres,
bilinear antialiased when it shrinks, and ``nearest`` as
``floor((i + 0.5) * in / out)`` (torch's ``nearest-exact``, not its
``nearest``).  The loss is batched over images as ``loss.batch_loss`` is:
per level it forms the BCE of every (offset, anchor, target) candidate's
mask, [N, 5, na, T, mh, mw].  Both CLIs run on ``--device`` (``cuda`` by
default).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from adaptiveisp_tpu_torch import api
from adaptiveisp_tpu_torch.detect.loss import (
    _candidate_table,
    bce_with_logits,
    per_image_loss_batch,
)
from adaptiveisp_tpu_torch.detect.metrics import (
    correct_from_iou,
    process_batch,
    summarize,
)
from adaptiveisp_tpu_torch.detect.model import (
    anchors_in_grid_units,
    decode_predictions,
)
from adaptiveisp_tpu_torch.detect.nms import non_max_suppression
from adaptiveisp_tpu_torch.detect.train_loop import DetectorTrainer
from adaptiveisp_tpu_torch import parallel

IOUV = np.linspace(0.5, 0.95, 10)


# --------------------------------------------------------------------------- #
# resize as jax.image.resize
# --------------------------------------------------------------------------- #
def _linear_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] weights of jax.image's ``compute_weight_mat`` for the
    triangle kernel, antialiased (the kernel widened by in/out when
    shrinking), float32."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(n_out, dtype=torch.float32, device=device)
                + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(n_in, dtype=torch.float32,
                                          device=device)[:, None]).abs()
    w = torch.clamp(1.0 - x / kernel_scale, min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    off = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * (n_in / n_out)
    return torch.floor(off).long().clamp(max=n_in - 1)


def resize(x: torch.Tensor, size, method: str = "bilinear") -> torch.Tensor:
    """``jax.image.resize`` of the last two dims of ``x`` to ``size``
    (h, w): ``bilinear`` (antialiased when shrinking) or ``nearest``."""
    h, w = x.shape[-2:]
    oh, ow = int(size[0]), int(size[1])
    if method == "nearest":
        if oh != h:
            x = x.index_select(-2, _nearest_index(h, oh, x.device))
        if ow != w:
            x = x.index_select(-1, _nearest_index(w, ow, x.device))
        return x
    if method != "bilinear":
        raise ValueError(f"unknown resize method {method!r}")
    x = x.float()
    if oh != h:
        x = torch.einsum("...hw,hH->...Hw", x,
                         _linear_weights(h, oh, x.device))
    if ow != w:
        x = torch.einsum("...hw,wW->...hW", x,
                         _linear_weights(w, ow, x.device))
    return x


# --------------------------------------------------------------------------- #
# mask helpers
# --------------------------------------------------------------------------- #
def crop_mask(masks: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Zero mask pixels outside each box.  masks [..., h, w]; boxes
    [..., 4] xyxy in mask pixels (broadcast against the masks' leading
    dims)."""
    h, w = masks.shape[-2:]
    x1, y1, x2, y2 = (boxes[..., k, None, None] for k in range(4))
    r = torch.arange(w, dtype=torch.float32, device=masks.device)
    c = torch.arange(h, dtype=torch.float32, device=masks.device)[:, None]
    keep = (r >= x1) & (r < x2) & (c >= y1) & (c < y2)
    return masks * keep


def process_mask(proto: torch.Tensor, coeffs: torch.Tensor,
                 boxes: torch.Tensor, shape, upsample: bool = True,
                 binarize: bool = True) -> torch.Tensor:
    """Coefficients + prototypes -> per-detection masks (crop before the
    upsample).  proto [mh, mw, nm]; coeffs [n, nm]; boxes [n, 4] xyxy in
    input pixels; shape (ih, iw).  Returns float [n, ih, iw] ([n, mh, mw]
    without ``upsample``), thresholded at 0.5 with ``binarize``."""
    mh, mw, nm = proto.shape
    ih, iw = shape
    masks = torch.sigmoid(coeffs @ proto.reshape(mh * mw, nm).T
                          ).reshape(-1, mh, mw)
    scale = torch.tensor([mw / iw, mh / ih, mw / iw, mh / ih],
                         dtype=masks.dtype, device=masks.device)
    masks = crop_mask(masks, boxes * scale)
    if upsample:
        masks = resize(masks, (ih, iw), "bilinear")
    if binarize:
        masks = (masks > 0.5).to(masks.dtype)
    return masks


def mask_iou(mask1: torch.Tensor, mask2: torch.Tensor,
             eps: float = 1e-7) -> torch.Tensor:
    """Pairwise IoU of flattened binary masks [n, h*w] x [m, h*w] -> [n, m]."""
    inter = torch.clamp(mask1 @ mask2.T, min=0)
    union = (mask1.sum(1)[:, None] + mask2.sum(1)[None, :]) - inter
    return inter / (union + eps)


def scale_image(im1_shape, masks, im0_shape, ratio_pad=None) -> np.ndarray:
    """Un-letterbox masks [h, w, n] back to the original image size, host
    NumPy in and out."""
    if ratio_pad is None:
        gain = min(im1_shape[0] / im0_shape[0], im1_shape[1] / im0_shape[1])
        pad = ((im1_shape[1] - im0_shape[1] * gain) / 2,
               (im1_shape[0] - im0_shape[0] * gain) / 2)
    else:
        pad = ratio_pad[1]
    top, left = int(pad[1]), int(pad[0])
    bottom = im1_shape[0] - int(pad[1])
    right = im1_shape[1] - int(pad[0])
    masks = np.asarray(masks, np.float32)[top:bottom, left:right]
    chw = torch.from_numpy(np.ascontiguousarray(np.moveaxis(masks, -1, 0))) \
        if masks.ndim == 3 else torch.from_numpy(np.ascontiguousarray(masks))
    out = resize(chw, (im0_shape[0], im0_shape[1]), "bilinear").numpy()
    return np.moveaxis(out, 0, -1) if masks.ndim == 3 else out


# 8-neighbourhood in clockwise order (rows grow downward): W NW N NE E SE S SW
_CW8 = ((0, -1), (-1, -1), (-1, 0), (-1, 1),
        (0, 1), (1, 1), (1, 0), (1, -1))


def _trace_boundary(mask, start):
    """Moore-neighbour border following with Jacob's stopping criterion.

    mask bool [H, W]; start (r, c), the topmost-leftmost pixel of one
    8-connected component.  Returns its external contour as (r, c) pixels,
    clockwise, start first (cv2.findContours(RETR_EXTERNAL)'s points)."""
    h, w = mask.shape
    r0, c0 = start
    # the raster scan reached start from the west: backtrack W (index 0)
    contour = [(r0, c0)]
    r, c = r0, c0
    back = 0
    first_leave = None
    for _ in range(4 * h * w + 8):
        found = -1
        for k in range(1, 9):
            d = (back + k) % 8
            dr, dc = _CW8[d]
            rr, cc = r + dr, c + dc
            if 0 <= rr < h and 0 <= cc < w and mask[rr, cc]:
                found = d
                break
        if found < 0:            # isolated single pixel
            break
        if first_leave is None:
            first_leave = found
        elif (r, c) == (r0, c0) and found == first_leave:
            break                # Jacob: left the start the same way again
        dr, dc = _CW8[found]
        r, c = r + dr, c + dc
        if (r, c) != (r0, c0):
            contour.append((r, c))  # the polygon stays open
        back = (found + 4) % 8   # from the new pixel back to the previous
    return contour


def _component_starts(mask):
    """Topmost-leftmost pixel of every 8-connected component."""
    h, w = mask.shape
    seen = np.zeros((h, w), bool)
    starts = []
    for r, c in zip(*np.nonzero(mask)):
        if seen[r, c]:
            continue
        starts.append((int(r), int(c)))
        stack = [(int(r), int(c))]
        seen[r, c] = True
        while stack:
            rr, cc = stack.pop()
            for dr, dc in _CW8:
                r2, c2 = rr + dr, cc + dc
                if 0 <= r2 < h and 0 <= c2 < w and mask[r2, c2] \
                        and not seen[r2, c2]:
                    seen[r2, c2] = True
                    stack.append((r2, c2))
    return starts


def find_contours(mask):
    """External contours of a binary mask, one [n, 2] float32 (x, y) array
    per 8-connected component."""
    m = np.asarray(mask) > 0.5
    return [np.array([(c, r) for r, c in _trace_boundary(m, s)], np.float32)
            for s in _component_starts(m)]


def masks_to_segments(masks, strategy: str = "largest"):
    """Binary masks [n, h, w] -> one polygon each: the longest contour
    ('largest') or all of them joined ('concat')."""
    segments = []
    for m in np.asarray(masks):
        cs = find_contours(m)
        if cs:
            if strategy == "concat":
                seg = np.concatenate([c.reshape(-1, 2) for c in cs])
            else:
                seg = cs[int(np.argmax([len(c) for c in cs]))].reshape(-1, 2)
        else:
            seg = np.zeros((0, 2), np.float32)
        segments.append(seg.astype(np.float32))
    return segments


# --------------------------------------------------------------------------- #
# segmentation loss
# --------------------------------------------------------------------------- #
def _level_mask_terms(pred, proto, targets, tmask, gt_masks, anchors, hyp,
                      nc: int):
    """Mask-loss terms of N images at one level.

    pred [N, ny, nx, na, 5+nc+nm]; proto [N, mh, mw, nm]; targets [N, T, 5];
    tmask [N, T]; gt_masks [N, T, mh, mw].  Every candidate of the
    detection loss's table contributes its mask's BCE, cropped to its
    target's box, averaged over all pixels and divided by the box's
    normalised area.  Returns (sum over valid candidates [N], n_matched
    [N])."""
    n, ny, nx, na, _ = pred.shape
    mh, mw = proto.shape[1:3]
    validf, gi, gj, a, _, _, n_matched = _candidate_table(
        (ny, nx, na), targets, tmask, anchors, hyp)
    b = torch.arange(n, device=pred.device)[:, None, None, None]
    coeffs = pred[b, gj, gi, a][..., 5 + nc:]           # [N, 5, na, T, nm]
    logits = torch.einsum("noatm,nhwm->noathw", coeffs, proto)
    bce = bce_with_logits(logits, gt_masks[:, None, None])

    xywhn = targets[..., 1:5]                           # [N, T, 4]
    scale = torch.tensor([mw, mh, mw, mh], dtype=torch.float32,
                         device=pred.device)
    xyxy = torch.cat([xywhn[..., :2] - xywhn[..., 2:] / 2,
                      xywhn[..., :2] + xywhn[..., 2:] / 2], dim=-1) * scale
    cropped = crop_mask(bce, xyxy[:, None, None])       # [N, 5, na, T, mh, mw]
    area = torch.clamp(xywhn[..., 2] * xywhn[..., 3], min=1e-9)
    per_cand = cropped.mean(dim=(4, 5)) / area[:, None, None, :]
    return (per_cand * validf).sum(dim=(1, 2, 3)), n_matched


def seg_loss_batch(preds, proto, targets, tmask, gt_masks, anchors_grid,
                   hyp):
    """Detection + mask loss of each image on its own (bs = 1).

    preds per-level [N, ny, nx, na, 5+nc+nm]; proto [N, mh, mw, nm];
    targets [N, T, 5]; tmask [N, T]; gt_masks [N, T, mh, mw] at the
    prototype resolution.  Returns (total [N], {"box", "obj", "cls",
    "seg"} each [N]); the mask term is averaged per level over the matched
    candidates and scaled by ``hyp.box``."""
    nc = preds[0].shape[-1] - 5 - proto.shape[-1]
    if tuple(gt_masks.shape[-2:]) != tuple(proto.shape[1:3]):
        raise ValueError(
            f"gt masks {tuple(gt_masks.shape[-2:])} are not at the "
            f"prototype resolution {tuple(proto.shape[1:3])}: set the "
            f"dataset's mask_ratio to imgsz/{proto.shape[1]} "
            f"(proto = first detect level upsampled 2x)")
    tmask = tmask.to(torch.bool)
    # the detection terms see only the 5 + nc channels
    total, comps = per_image_loss_batch(
        [p[..., :5 + nc] for p in preds], targets, tmask, anchors_grid, hyp)
    lseg = 0.0
    for i, pred in enumerate(preds):
        s, n = _level_mask_terms(pred, proto, targets, tmask, gt_masks,
                                 anchors_grid[i], hyp, nc)
        has = (n > 0).to(torch.float32)
        lseg = lseg + has * s / torch.clamp(n, min=1.0)
    lseg = lseg * hyp.box
    return total[:, 0] + lseg, dict(comps, seg=lseg)


def per_image_seg_loss(preds, proto, targets, tmask, gt_masks,
                       anchors_grid, hyp):
    """:func:`seg_loss_batch` for ONE image: preds per-level
    [ny, nx, na, no], proto [mh, mw, nm], targets [T, 5], tmask [T],
    gt_masks [T, mh, mw] -> (scalar total, components)."""
    total, comps = seg_loss_batch(
        [p[None] for p in preds], proto[None], targets[None], tmask[None],
        gt_masks[None], anchors_grid, hyp)
    return total[0], {k: v[0] for k, v in comps.items()}


def batch_seg_loss(preds, proto, targets, tmask, gt_masks, anchors_grid,
                   hyp):
    """The mean of the per-image losses times N, and each component's
    mean (JAX's ``vmap`` of the per-image loss)."""
    totals, comps = seg_loss_batch(preds, proto, targets, tmask, gt_masks,
                                   anchors_grid, hyp)
    return (totals.mean() * targets.shape[0],
            {k: v.mean() for k, v in comps.items()})


# --------------------------------------------------------------------------- #
# specs, step, validation, trainer
# --------------------------------------------------------------------------- #
def seg_spec_from(spec: Dict[str, Any], nm: int = 32,
                  npr: int = 256) -> Dict[str, Any]:
    """Any detection spec's segmentation variant: its Detect row becomes
    Segment with ``nm`` mask coefficients and ``npr`` prototype channels."""
    out = dict(spec)
    head = [list(r) for r in spec["head"]]
    frm, num, mod, args = head[-1]
    assert mod == "Detect", f"last head row must be Detect, got {mod}"
    head[-1] = [frm, num, "Segment", list(args) + [nm, npr]]
    out["head"] = head
    return out


def make_segment_train_step(anchors_grid: Sequence, hyp, mesh=None):
    """``step(state, images, targets, tmask, gt_masks) -> (state, {"loss",
    "components"})``: the detector's step with :func:`batch_seg_loss`.

    mesh: as ``make_detector_train_step``'s.  The loss is the sum of the
    per-image losses, so a rank's term is the sum over its rows; the
    gradients are summed over the ranks and the loss and components
    returned are the global batch's."""

    def step(state, images, targets, tmask, gt_masks):
        model = state.model
        model.train()
        parallel.sync_gradients(state.optimizer, mesh, average=False)
        with parallel.data_parallel(mesh):
            preds, proto = model(images)
            total, comps = batch_seg_loss(preds, proto, targets, tmask,
                                          gt_masks, anchors_grid, hyp)
            state.optimizer.zero_grad(set_to_none=True)
            total.backward()
        state.optimizer.step()
        state.ema.update(model)
        state.step += 1
        total = total.detach()
        comps = {k: v.detach() for k, v in comps.items()}
        if mesh is not None:
            total = parallel.all_reduce(mesh, total)
            comps = {k: parallel.all_reduce(mesh, v, "mean")
                     for k, v in comps.items()}
        return state, {"loss": total, "components": comps}

    return step


def non_max_suppression_seg(prediction, nm: int, **kw):
    """Multi-label NMS keeping each detection's mask coefficients."""
    return non_max_suppression(prediction, multi_label=True, nm=nm, **kw)


@torch.no_grad()
def validate_segmenter(model, dataset, spec, nm: int = 32,
                       conf_thres: float = 0.001, iou_thres: float = 0.6,
                       max_det: int = 100, max_batches=None,
                       mask_thres: float = 0.5) -> Dict[str, Any]:
    """Box and mask mAP over a ``SegmentDataset`` (eval mode, on the
    model's device): one greedy matching rule, boxes by box IoU, masks by
    mask IoU at the input resolution."""
    dev = next(model.parameters()).device
    was_training = model.training
    model.eval()
    size = dataset.img_size
    stats_box, stats_mask = [], []
    for bi, (images, targets, tmask, gt_masks) in enumerate(
            dataset.epoch_batches(shuffle=False)):
        if max_batches is not None and bi >= max_batches:
            break
        preds, proto = model(torch.from_numpy(images).to(dev))
        dets, nvalid, coeffs = non_max_suppression_seg(
            decode_predictions(preds, spec), nm=nm, conf_thres=conf_thres,
            iou_thres=iou_thres, max_det=max_det)
        dets_np, nvalid = dets.cpu().numpy(), nvalid.cpu().numpy()
        for i in range(images.shape[0]):
            n = int(nvalid[i])
            det = dets_np[i][:n]
            tm = tmask[i]
            t = targets[i][tm]
            lab = np.zeros((len(t), 5), np.float32)
            if len(t):
                lab[:, 0] = t[:, 0]
                xywh = t[:, 1:] * size
                lab[:, 1:] = np.concatenate([xywh[:, :2] - xywh[:, 2:] / 2,
                                             xywh[:, :2] + xywh[:, 2:] / 2],
                                            1)
            stats_box.append((process_batch(det, lab, IOUV), det[:, 4],
                              det[:, 5], lab[:, 0]))
            if n and len(t):
                pm = process_mask(proto[i], coeffs[i][:n], dets[i][:n, :4],
                                  (size, size))
                gm = resize(torch.from_numpy(gt_masks[i][tm]).to(dev),
                            (size, size), "nearest")
                miou = mask_iou(gm.reshape(len(t), -1),
                                (pm.reshape(n, -1) > mask_thres).float())
                correct_mask = correct_from_iou(
                    miou.cpu().numpy(), lab[:, 0:1] == det[:, 5], IOUV)
            else:
                correct_mask = np.zeros((n, len(IOUV)), bool)
            stats_mask.append((correct_mask, det[:, 4], det[:, 5],
                               lab[:, 0]))
    model.train(was_training)
    box, mask = summarize(stats_box), summarize(stats_mask)
    return {"box": box, "mask": mask,
            "fitness": 0.1 * (box["map50"] + mask["map50"]) / 2
                       + 0.9 * (box["map"] + mask["map"]) / 2}


class SegmentTrainer(DetectorTrainer):
    """``DetectorTrainer`` with the segmentation step, batches of four
    arrays (images, targets, tmask, gt_masks), mask mosaics and box + mask
    mAP validation.  Keyword arguments past ``nm`` go to
    ``DetectorTrainer`` (``device``, ``val_batches``, ``loggers`` ...)."""

    _batch_arity = 4

    def __init__(self, model, spec, train_ds, val_ds=None, cfg=None,
                 hyp=None, save_dir=None, nm: int = 32, mesh=None,
                 plots: bool = False, names=None, **kw):
        self.nm = nm
        super().__init__(model, spec, train_ds, val_ds, cfg=cfg, hyp=hyp,
                         save_dir=save_dir, mesh=mesh, plots=plots,
                         names=names, **kw)

    def _build_step(self):
        return make_segment_train_step(anchors_in_grid_units(self.spec),
                                       self.hyp, mesh=self.mesh)

    def _plot_train_batch(self, bi, images, targets, tmask, *extra):
        """train_batch mosaics with the instance masks blended in."""
        from adaptiveisp_tpu_torch.obs.plots import plot_images_and_masks

        rows = []
        for i in range(images.shape[0]):
            for t in np.asarray(targets[i])[np.asarray(tmask[i])]:
                rows.append([i, t[0], t[1], t[2], t[3], t[4]])
        gt_masks = extra[0] if extra else np.zeros(
            (images.shape[0], 0, 1, 1), np.float32)
        plot_images_and_masks(
            images, np.asarray(rows, np.float32), gt_masks,
            tmask=np.asarray(tmask),
            fname=os.path.join(self.save_dir, f"train_batch{bi}.jpg"),
            names=self.names)

    def _plot_final_val(self):
        # box + mask validation has no curve plotter: the per-epoch
        # results.csv and the mask mosaics are the artifacts
        pass

    def _validate(self):
        metrics = {"box": {"map50": 0.0, "map": 0.0},
                   "mask": {"map50": 0.0, "map": 0.0}, "fitness": 0.0}
        if self.val_ds is not None:
            metrics = validate_segmenter(
                self.ema_model(), self.val_ds, self.spec, nm=self.nm,
                max_batches=self.val_batches)
        return metrics, metrics["fitness"]


# --------------------------------------------------------------------------- #
# CLIs
# --------------------------------------------------------------------------- #
def load_segment_weights(path: str, spec) -> Dict[str, torch.Tensor]:
    """A segmentation model's ``state_dict`` from a ``SegmentTrainer``
    checkpoint: the port's ``.pt`` (its ``model``) or the JAX package's
    ``.pkl`` (flax variables under ``model``, through
    ``convert.yolo_from_flax``)."""
    if path.endswith((".pkl", ".pickle")):
        import pickle

        from adaptiveisp_tpu_torch.convert import yolo_from_flax

        with open(path, "rb") as f:
            ckpt = pickle.load(f)
        v = ckpt["model"] if "model" in ckpt else ckpt
        return yolo_from_flax(v["params"], v["batch_stats"], spec)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return ckpt["model"] if "model" in ckpt else ckpt


def _new_model(spec, seed: int, dev, weights: Optional[str] = None):
    model = api.load_detector(spec=spec, seed=seed, device=dev).model
    if weights:
        model.load_state_dict(load_segment_weights(weights, spec))
    return model


def main(argv=None):
    """``python -m adaptiveisp_tpu_torch.detect.segment``: run a
    segmentation model over images, a video or streams, print each frame's
    instances, and with ``--save_dir`` write mask overlays (and with
    ``--save_txt`` one polygon line per instance).  Returns one dict per
    frame (name, detections [n, 6], masks [n, imgsz, imgsz] or None)."""
    import argparse

    from adaptiveisp_tpu_torch.data.dataset_config import COCO_NAMES
    from adaptiveisp_tpu_torch.data.letterbox import letterbox
    from adaptiveisp_tpu_torch.data.sources import open_source
    from adaptiveisp_tpu_torch.detect.spec import resolve_spec
    from adaptiveisp_tpu_torch.obs.logging import save_img

    p = argparse.ArgumentParser()
    p.add_argument("--source", required=True,
                   help="image/dir/glob/video/webcam/rtsp (data.sources)")
    p.add_argument("--weights", default=None,
                   help="SegmentTrainer checkpoint: the port's .pt or the "
                        "JAX package's .pkl (best/last)")
    p.add_argument("--spec", default="yolov3-tiny",
                   help="base detection spec name or YAML; -seg derived")
    p.add_argument("--nm", type=int, default=32)
    p.add_argument("--npr", type=int, default=256)
    p.add_argument("--imgsz", type=int, default=512)
    p.add_argument("--conf_thres", type=float, default=0.25)
    p.add_argument("--iou_thres", type=float, default=0.45)
    p.add_argument("--max_det", type=int, default=100)
    p.add_argument("--save_txt", action="store_true",
                   help="dump per-instance polygon .txt next to overlays")
    p.add_argument("--save_dir", default=None,
                   help="save mask overlays here")
    p.add_argument("--vid_stride", type=int, default=1)
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    dev = api.resolve_device(args.device)
    spec = seg_spec_from(resolve_spec(args.spec), nm=args.nm, npr=args.npr)
    model = _new_model(spec, 0, dev, args.weights).eval()
    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)

    results = []
    src = open_source(args.source, vid_stride=args.vid_stride,
                      max_frames=args.max_frames)
    for s in (src if isinstance(src, list) else [src]):
        for name, frame, _ in s:
            lb, _, _ = letterbox(frame, args.imgsz, color=(114 / 255,) * 3)
            with torch.no_grad():
                preds, proto = model(torch.from_numpy(
                    np.ascontiguousarray(lb[None], np.float32)).to(dev))
                dets, nvalid, coeffs = non_max_suppression_seg(
                    decode_predictions(preds, spec), nm=args.nm,
                    conf_thres=args.conf_thres, iou_thres=args.iou_thres,
                    max_det=args.max_det)
            n = int(nvalid[0])
            det = dets[0][:n].cpu().numpy()
            print(f"{name}: {n} instances")
            for d in det:
                cls = (COCO_NAMES[int(d[5])]
                       if int(d[5]) < len(COCO_NAMES) else int(d[5]))
                print(f"  {cls} {d[4]:.2f} "
                      f"[{d[0]:.0f},{d[1]:.0f},{d[2]:.0f},{d[3]:.0f}]")
            masks = None
            if args.save_dir and n:
                with torch.no_grad():
                    masks = process_mask(proto[0], coeffs[0][:n],
                                         dets[0][:n, :4],
                                         (args.imgsz, args.imgsz)
                                         ).cpu().numpy()
                safe = name.replace(":", "_")
                if args.save_txt:
                    # one line per instance: cls x1 y1 x2 y2 ... (normalised)
                    segs = masks_to_segments(masks > 0.5)
                    with open(os.path.join(args.save_dir,
                                           safe + ".txt"), "w") as f:
                        for d, seg in zip(det, segs):
                            xy = (seg / args.imgsz).reshape(-1)
                            line = " ".join(f"{v:.6g}" for v in xy)
                            f.write(f"{int(d[5])} {line}\n")
                overlay = lb.copy()
                for mi in range(n):
                    color = np.array([(37 * (mi + 1)) % 256,
                                      (91 * (mi + 3)) % 256,
                                      (53 * (mi + 7)) % 256],
                                     np.float32) / 255.0
                    m = masks[mi][..., None]
                    overlay = overlay * (1 - 0.45 * m) + color * 0.45 * m
                save_img(overlay, os.path.join(args.save_dir,
                                               safe + "_seg.png"))
            results.append({"name": name, "det": det, "masks": masks})
    return results


def train_main(argv=None):
    """``python -m adaptiveisp_tpu_torch.detect.segment train``: the
    segmentation trainer CLI (hyp YAML, plots, resume), or
    ``--validate-only`` for box + mask mAP over ``--data``."""
    import argparse
    import dataclasses

    import yaml

    from adaptiveisp_tpu_torch.data.segment_dataset import SegmentDataset
    from adaptiveisp_tpu_torch.detect.hyp import load_hyp, split_hyp
    from adaptiveisp_tpu_torch.detect.model import model_strides
    from adaptiveisp_tpu_torch.detect.spec import resolve_spec

    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True,
                   help="train images: dir, .txt list, or glob "
                        "(labels = polygon .txt)")
    p.add_argument("--val-data", default=None)
    p.add_argument("--spec", default="yolov3-tiny",
                   help="base detection spec; the -seg head is derived")
    p.add_argument("--nm", type=int, default=32)
    p.add_argument("--npr", type=int, default=256)
    p.add_argument("--imgsz", type=int, default=320)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--hyp", default=None,
                   help="hyperparameter YAML (defaults = hyp.scratch-low)")
    p.add_argument("--lr0", type=float, default=None)
    p.add_argument("--patience", type=int, default=100)
    p.add_argument("--mask-ratio", type=int, default=None,
                   help="gt-mask downsample vs imgsz; default = the "
                        "spec's Proto resolution (first detect stride / "
                        "2), e.g. 4 for yolov3, 8 for yolov3-tiny")
    p.add_argument("--nc", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save-dir", default="runs/train-seg")
    p.add_argument("--exist-ok", action="store_true",
                   help="write into --save-dir even if it exists "
                        "(default: auto-increment)")
    p.add_argument("--plots", action="store_true")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel ranks: 0 off, N ranks (NCCL on N "
                        "cards, gloo with --device cpu), below 0 every card")
    p.add_argument("--optimizer", default="SGD",
                   choices=["SGD", "Adam", "AdamW"])
    p.add_argument("--linear-lr", action="store_true",
                   help="linear LR decay (the reference default schedule)")
    p.add_argument("--freeze", type=int, nargs="+", default=None,
                   help="freeze layers: single N = layers 0..N-1")
    p.add_argument("--resume", default=None,
                   help="last.pt to continue from (optimizer/EMA/epoch)")
    p.add_argument("--weights", default=None,
                   help="with --validate-only: checkpoint to evaluate")
    p.add_argument("--validate-only", action="store_true",
                   help="box+mask mAP over --data, no training")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    mesh = None
    if not args.validate_only:
        mesh, launched = parallel.cli_mesh(
            args.dp, args.device,
            "adaptiveisp_tpu_torch.detect.segment:train_main", argv)
        if launched:
            return None

    dev = api.resolve_device(args.device) if mesh is None else mesh.device
    base = resolve_spec(args.spec)
    if args.nc is not None:
        base = dict(base, nc=args.nc)
    spec = seg_spec_from(base, nm=args.nm, npr=args.npr)
    if args.mask_ratio is None:
        # the Proto tower upsamples the first detect level 2x
        args.mask_ratio = max(1, model_strides(spec)[0] // 2)
        print(f"mask-ratio {args.mask_ratio} (from the spec's Proto "
              f"resolution)")

    hyp_dict = load_hyp(args.hyp)
    if args.lr0 is not None:
        hyp_dict["lr0"] = args.lr0
    cfg, loss_hyp, aug_hyp = split_hyp(
        hyp_dict, nl=len(spec["anchors"]), nc=spec["nc"],
        imgsz=args.imgsz, epochs=args.epochs,
        batch_size=args.batch_size, patience=args.patience)
    freeze = None
    if args.freeze:
        freeze = (tuple(range(args.freeze[0])) if len(args.freeze) == 1
                  else tuple(args.freeze))
    cfg = dataclasses.replace(cfg, optimizer=args.optimizer,
                              cos_lr=not args.linear_lr, freeze=freeze or ())

    if args.validate_only:
        model = _new_model(spec, args.seed, dev, args.weights)
        ds = SegmentDataset(args.data, img_size=args.imgsz,
                            batch_size=args.batch_size, augment=False,
                            mask_ratio=args.mask_ratio)
        metrics = validate_segmenter(model, ds, spec, nm=args.nm)
        print(f"box mAP50 {metrics['box']['map50']:.4f} "
              f"mAP {metrics['box']['map']:.4f} | "
              f"mask mAP50 {metrics['mask']['map50']:.4f} "
              f"mAP {metrics['mask']['map']:.4f}")
        return metrics

    model = _new_model(spec, args.seed, dev)
    train_ds = SegmentDataset(
        args.data, img_size=args.imgsz, batch_size=args.batch_size,
        augment=True, mask_ratio=args.mask_ratio,
        fliplr=aug_hyp.fliplr, copy_paste=aug_hyp.copy_paste,
        seed=args.seed)
    val_ds = None
    if args.val_data:
        val_ds = SegmentDataset(args.val_data, img_size=args.imgsz,
                                batch_size=args.batch_size, augment=False,
                                mask_ratio=args.mask_ratio)
    if args.save_dir and not args.resume:
        from adaptiveisp_tpu_torch.obs.logging import increment_path

        if mesh is None or mesh.is_main:
            args.save_dir = increment_path(args.save_dir,
                                           exist_ok=args.exist_ok)
        args.save_dir = parallel.broadcast_object(mesh, args.save_dir)
    trainer = SegmentTrainer(model, spec, train_ds, val_ds, cfg=cfg,
                             hyp=loss_hyp, save_dir=args.save_dir,
                             nm=args.nm, plots=args.plots, device=dev,
                             mesh=mesh)
    if args.save_dir and (mesh is None or mesh.is_main):
        os.makedirs(args.save_dir, exist_ok=True)
        with open(os.path.join(args.save_dir, "opt.yaml"), "w") as f:
            yaml.safe_dump(vars(args), f, sort_keys=False)
        with open(os.path.join(args.save_dir, "hyp.yaml"), "w") as f:
            yaml.safe_dump(hyp_dict, f, sort_keys=False)
    if args.resume:
        start = trainer.resume(args.resume)
        print(f"resumed from {args.resume} at epoch {start}")
    history = trainer.fit()
    for log in history:
        print(f"epoch {log.epoch}: loss {log.loss:.4f} "
              f"fitness {log.fitness:.4f} ({log.seconds:.1f}s)")
    print(f"best fitness {trainer.best_fitness:.4f} -> "
          f"{args.save_dir}/best.pt")
    return history


if __name__ == "__main__":
    import sys as _sys

    _argv = _sys.argv[1:]
    if _argv and _argv[0] == "train":
        train_main(_argv[1:])
    elif _argv and _argv[0] == "predict":
        main(_argv[1:])
    else:
        main(_argv)
