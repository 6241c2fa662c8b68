"""The numbers that decide ``correct``: the served outputs against the plain
reference's, for the same inputs and weights.

Served adaptive inference yields, per batch, each step's selection and
parameters, the retouched images and the NMS detections.  The reference
rolls out the same images with the same noise and weights; its selections,
parameters and images are compared with the served ones, and its detector
and NMS run on the served images (the reference reads them only to judge
them, as a language model's reference reads the served tokens), so a fault
in the detector or NMS is not hidden behind the render's rounding.

Training yields its first steps' losses, gradients and parameters, and the
replay pool's batches and write-backs; the reference follows the same
steps with its own pool (``training.follow``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def rollout_numbers(sel, params, image, ref_sel, ref_params, ref_image
                    ) -> Dict[str, float]:
    """sel [steps, N]; params [steps, N, P]; image [N, H, W, 3] (either
    side): the selections that differ, the largest parameter error over
    every step and image (a different choice shows there too), and the
    largest and the root-mean-square pixel errors of the images."""
    dev = ref_sel.device
    diff = image.to(dev) - ref_image
    return {"sel_mismatch": float((sel.to(dev) != ref_sel).sum()),
            "param_err": float((params.to(dev) - ref_params).abs().max()),
            "image_err": float(diff.abs().max()),
            "image_rms": float(diff.square().mean().sqrt())}


def detection_numbers(dets: np.ndarray, n_valid: np.ndarray,
                      ref_dets: np.ndarray, ref_n: np.ndarray,
                      max_det: int, match_conf: float = 0.05,
                      match_box_px: float = 8.0, cut_tie: float = 1e-5
                      ) -> Dict[str, float]:
    """Detections [N, max_det, 6] (xyxy, conf, class) and counts, served
    against the reference's on the same images, as multisets of rows: each
    served row (in score order) is matched to the unused reference row of
    its class nearest to it, within ``match_conf`` and ``match_box_px``.
    Returns the count difference, the unmatched rows and the largest box
    and score errors over the matches.  Where ``max_det`` rows were kept,
    which rows within ``cut_tie`` of the lowest kept score make the cut is
    a tie-break: those rows are left out on both sides."""
    count_diff, unmatched, box_err, conf_err = 0, 0, 0.0, 0.0
    for i in range(dets.shape[0]):
        got = np.asarray(dets[i, :int(n_valid[i])], np.float64)
        want = np.asarray(ref_dets[i, :int(ref_n[i])], np.float64)
        count_diff += abs(len(got) - len(want))
        if len(got) >= max_det or len(want) >= max_det:
            low = min(got[:, 4].min() if len(got) else np.inf,
                      want[:, 4].min() if len(want) else np.inf)
            got = got[got[:, 4] > low + cut_tie]
            want = want[want[:, 4] > low + cut_tie]
        used = np.zeros(len(want), bool)
        for r in got[np.argsort(-got[:, 4], kind="stable")]:
            cand = np.flatnonzero(~used & (want[:, 5] == r[5]) & (
                np.abs(want[:, 4] - r[4]) <= match_conf))
            if not len(cand):
                unmatched += 1
                continue
            d = np.abs(want[cand, :4] - r[:4]).max(1)
            j = int(d.argmin())
            if d[j] > match_box_px:
                unmatched += 1
                continue
            used[cand[j]] = True
            box_err = max(box_err, float(d[j]))
            conf_err = max(conf_err, float(abs(want[cand[j], 4] - r[4])))
        unmatched += int((~used).sum())
    return {"det_count_diff": float(count_diff),
            "det_unmatched": float(unmatched),
            "det_box_px": box_err, "det_conf": conf_err}


def action_gap(pdf, noise, actions) -> float:
    """How far sampled actions lie from the reference's: the distance of
    each step's uniform noise from the interval of the inverse CDF that the
    taken action owns under the reference's probabilities (0 where the
    reference samples the same action)."""
    pdf = pdf / (pdf.sum(dim=1, keepdim=True) + 1e-36)
    a = actions.to(pdf.device).long()[:, None]
    lo = (torch.cumsum(pdf, dim=1) - pdf).gather(1, a)
    hi = lo + pdf.gather(1, a)
    u = noise.to(pdf.device)
    return float(torch.clamp(torch.maximum(lo - u, u - hi), min=0).max())


def _row_rms(a, b) -> torch.Tensor:
    d = a.to(b.device).float() - b.float()
    return d.square().flatten(1).mean(1).sqrt()


def pool_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The replay pool, step by step: each batch that the pool handed the
    step, and each sampled slot after the write-back, against the
    reference's own pool.  ``pool_image_err``: the largest per-image RMS
    gap of a handed image that is a fresh decode (any step) or of a slot
    that the first step writes back (both sides' weights still equal);
    ``pool_image_drift``: the same for the later steps' write-backs, handed
    or written, whose gap grows with the two sides' updates (printed, not
    compared); ``pool_loss_err``: the largest gap of a cached input loss,
    handed or written back; ``pool_row_mismatch``: the rows whose state or
    labels, handed, or whose state left in the slot (the reference's next
    state where it keeps the slot, the initial state where it refreshes
    it), differ."""
    img, drift, loss, rows = 0.0, 0.0, 0.0, 0
    for h, (ri, rs, rl, rt, rm, fresh) in zip(prog["handed"],
                                              ref["handed"]):
        pi, ps, pl, pt, pm = h[:5]
        gap = _row_rms(pi, ri)
        if fresh.any():
            img = max(img, float(gap[fresh].max()))
        if (~fresh).any():
            drift = max(drift, float(gap[~fresh].max()))
        loss = max(loss, float((pl.to(rl.device) - rl).abs().max()))
        bad = (torch.as_tensor(ps, device=rs.device) != rs).any(1)
        bad |= (pm.to(rm.device) != rm).any(1)
        bad |= ((pt.to(rt.device) - rt).abs() > 1e-5).flatten(1).any(1)
        rows += int(bad.sum())
    for k, (w, (ri, rs, rl, keep)) in enumerate(zip(prog["written"],
                                                    ref["written"])):
        pi, ps, pl = w[:3]
        if keep.any():
            gap = float(_row_rms(pi, ri)[keep].max())
            img, drift = (max(img, gap), drift) if k == 0 else (
                img, max(drift, gap))
            loss = max(loss, float((pl.to(rl.device) - rl)[keep].abs().max()))
        rows += int((torch.as_tensor(ps, device=rs.device) != rs).any(1)
                    .sum())
    return {"pool_image_err": img, "pool_image_drift": drift,
            "pool_loss_err": loss, "pool_row_mismatch": float(rows)}


def _loss_rel(prog, ref, key: str) -> float:
    """The worst step's gap of one loss, over the larger of the
    reference's value at that step and its mean magnitude over the
    steps."""
    scale = float(np.mean([abs(r[key]) for r in ref]))
    return max(abs(p[key] - r[key]) / max(abs(r[key]), scale, 1e-12)
               for p, r in zip(prog, ref))


def _leaf_gaps(got, want, keep):
    """Each kept leaf's gap between the two sides' norms, over the larger
    of the reference's norm of that leaf and of the median kept leaf."""
    med = float(np.median([want[k] for k in keep]))
    return {k: abs(got[k] - want[k]) / max(want[k], med, 1e-30)
            for k in keep}


def train_numbers(prog: Dict, ref: Dict, initial: Dict[str, torch.Tensor],
                  tiny: float = 1e-3) -> Dict[str, float]:
    """The served trainer's first steps against the reference's.

    ``agent_loss_rel``, ``value_loss_rel``: each loss's worst step
    (:func:`_loss_rel`); the pool's numbers (:func:`pool_numbers`);
    ``action_gap``: the sampled actions against the reference's
    probabilities (:func:`action_gap`); ``grad_rel`` and ``update_rel``: by
    the worst leaf, and ``..._median`` by the median leaf, the gap between
    the two sides' norms of the first step's gradient and of the
    parameters' change over the steps, over the larger of the reference's
    norm of that leaf and of the median leaf.  Leaves whose reference
    gradient is zero (the heads of filters that no image chose) or under
    ``tiny`` times the median of the others move by round-off alone under
    Adam and are left out of both."""
    names = list(ref["grads"])
    g_ref = {k: float(ref["grads"][k].norm()) for k in names}
    moved = [g for g in g_ref.values() if g > 0]
    g_med = float(np.median(moved)) if moved else 0.0
    keep = [k for k in names if g_ref[k] > 0 and g_ref[k] >= tiny * g_med]
    g_prog = {k: float(prog["grads"][k].to(ref["grads"][k].device).norm())
              for k in keep}
    d_ref = {k: float((ref["params"][k] - initial[k]).norm()) for k in keep}
    d_prog = {k: float((prog["params"][k].to(initial[k].device)
                        - initial[k]).norm()) for k in keep}
    g_gap, d_gap = (_leaf_gaps(g_prog, g_ref, keep),
                    _leaf_gaps(d_prog, d_ref, keep))
    worst_g, worst_d = max(g_gap, key=g_gap.get), max(d_gap, key=d_gap.get)
    out = {"agent_loss_rel": _loss_rel(prog["losses"], ref["losses"],
                                       "agent_loss"),
           "value_loss_rel": _loss_rel(prog["losses"], ref["losses"],
                                       "value_loss")}
    out.update(pool_numbers(prog, ref))
    out.update({
        "action_gap": max(action_gap(pdf, u, a) for (pdf, u), a in zip(
            ref["pdfs"], prog["selected"])),
        "grad_rel": g_gap[worst_g],
        "grad_rel_median": float(np.median(list(g_gap.values()))),
        "update_rel": d_gap[worst_d],
        "update_rel_median": float(np.median(list(d_gap.values()))),
        "worst_grad_leaf": worst_g,
        "worst_grad_leaf_share": g_ref[worst_g] / g_med,
        "worst_update_leaf": worst_d,
        "worst_update_leaf_share": g_ref[worst_d] / g_med,
        "leaves_left_out": float(len(names) - len(keep))})
    return out


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """Each number's largest value over the checked batches."""
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def to_checks(numbers: Dict[str, float], limits: Dict[str, float]):
    """(name, value, limit) for every limited number, in the limits'
    order; a number the run did not produce reads None (not correct)."""
    return [(k, numbers.get(k), float(v)) for k, v in limits.items()]
