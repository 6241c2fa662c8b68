"""High-resolution qualitative rollout (port of
``adaptiveisp_tpu/eval/hr_render.py``).

The reference's DynamicISP.val (train.py:489-611): the policy reads the
512-letterboxed proxy, and the filters it picks apply with the same
parameters to the full-resolution frame (the agent's ``high_res`` slot),
one image at a time.  Writes the per-step frames and a strip of 64-px
thumbnails of the proxy's trajectory per input.  ``spatial_shard > 1``
spreads each full-resolution frame's rows over that many ranks (JAX's sp
axis, ``train/mesh.make_mesh_2d``): every rank reads the proxy, and the
filters apply to the rank's block of rows with the halos of the windowed
ones; rank 0 gathers the frames and writes them.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from adaptiveisp_tpu_torch import api, parallel
from adaptiveisp_tpu_torch.data.datasets import ISPDataset
from adaptiveisp_tpu_torch.data.letterbox import resize_bilinear
from adaptiveisp_tpu_torch.obs.logging import save_img
from adaptiveisp_tpu_torch.policy.states import (
    STATE_STOPPED_DIM,
    get_initial_states,
    get_noise,
)
from adaptiveisp_tpu_torch.train import checkpoint as ckpt_lib


@torch.no_grad()
def run_hr_validation(cfg, tcfg, data, model_weights: Optional[str],
                      save_dir: str, steps: int = 5, max_images: int = -1,
                      spatial_shard: int = 1, device="cuda", mesh=None):
    """Roll the agent out on ``data["val"]`` and write
    ``save_dir/val-images/{step-<s>,all-step}/<name>``; returns that
    directory.

    model_weights: a checkpoint directory or weights-only file
    (:func:`..train.checkpoint.load_agent_weights`), or None for seeded
    random weights.  The JAX function's ``yolo_variables``, unused there,
    is dropped.  spatial_shard > 1: ``mesh`` a (1 x spatial_shard) mesh of
    ``parallel.make_grid``, made here (inside a process group of that
    many ranks) when not given; each rank calls this function.
    """
    if spatial_shard > 1:
        if mesh is None:
            mesh = parallel.make_grid(1, spatial_shard,
                                      parallel.SPATIAL_AXIS, device=device)
        if (mesh.axis_names != (parallel.DATA_AXIS, parallel.SPATIAL_AXIS)
                or mesh.shape != (1, spatial_shard)):
            raise ValueError(f"spatial_shard={spatial_shard} needs a "
                             f"(1 x {spatial_shard}) data x spatial mesh, "
                             f"got {mesh.axis_names} {mesh.shape}")
        device = mesh.device
    else:
        mesh = None
    writes = mesh is None or mesh.is_main
    image_dir = os.path.join(save_dir, "val-images")
    if writes:
        for i in range(steps):
            os.makedirs(os.path.join(image_dir, f"step-{i}"), exist_ok=True)
        os.makedirs(os.path.join(image_dir, "all-step"), exist_ok=True)

    state_dict = (ckpt_lib.load_agent_weights(model_weights, cfg)
                  if model_weights else None)
    isp = api.load_adaptive_isp(cfg=cfg, steps=steps, device=device,
                                state_dict=state_dict)
    agent, dev = isp.agent, isp.device

    ds = ISPDataset(data["val"], img_size=tcfg.imgsz,
                    source=data.get("source", "normalize"),
                    high_res=True, train=False)
    rng = np.random.RandomState(0)
    n_total = len(ds) if max_images < 0 else min(max_images, len(ds))
    for i in range(n_total):
        rec = ds[i]
        img = torch.from_numpy(rec["im"][None]).to(dev)
        height = rec["im_hr"].shape[0]
        rows = None if mesh is None else parallel.Rows(mesh, height)
        hr = (torch.from_numpy(rec["im_hr"][None]).to(dev) if rows is None
              else parallel.shard_image(mesh, rec["im_hr"][None]))
        states = torch.from_numpy(get_initial_states(
            1, cfg.num_state_dim)).to(dev)
        traj = [rec["im"]]
        fname = os.path.split(rec["path"])[1]
        for s in range(steps):
            z = torch.from_numpy(get_noise(rng, 1, cfg.z_dim,
                                           cfg.z_type)).to(dev)
            img, states, _, _, hr, _ = agent(img, z, states, 1.0,
                                             train=False, high_res=hr,
                                             high_res_rows=rows)
            traj.append(img[0].cpu().numpy())
            frame = hr if rows is None else parallel.gather_rows(
                mesh, hr, height)
            if writes:
                save_img(frame[0].cpu().numpy(),
                         os.path.join(image_dir, f"step-{s}", fname))
            if float(states[0, STATE_STOPPED_DIM]) > 0:
                break
        if writes:
            strip = np.concatenate([resize_bilinear(t, 64, 64)
                                    for t in traj], axis=1)
            save_img(strip, os.path.join(image_dir, "all-step", fname))
    return image_dir
