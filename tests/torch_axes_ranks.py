"""What each rank of the port's four-rank meshes runs for
``tests/test_torch_parallel_axes.py`` (the spatially sharded render, sp;
the expert-parallel blend, ep; the pipelined render, pp) and
``tests/test_torch_tp.py`` (the tensor-parallel detector step, tp), each
on (2 x 2) meshes of four gloo ranks, and their refusals.

Spawned ranks import this module by name, so it imports only the port,
torch and numpy.  Each rank reads ``inputs.pt`` from the directory it is
given, runs every scenario on one torch thread and writes ``rank<r>.pt``.
"""

import os

import numpy as np
import torch

from adaptiveisp_tpu_torch.train import mesh as mesh_lib

RANKS = 4
RANKS_TIMEOUT = 600


def launch(root, target: str):
    """Start the four gloo ranks on the CPU running ``target`` on
    ``root``; returns a function that waits for them and returns their
    outputs in rank order."""
    ranks = mesh_lib.launch(f"{__name__}:{target}", RANKS, str(root),
                            device="cpu")

    def outputs():
        ranks.wait(timeout=RANKS_TIMEOUT)
        return [torch.load(os.path.join(root, f"rank{r}.pt"),
                           weights_only=False) for r in range(RANKS)]

    return outputs


def _refusal(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _sp(inp, cfg):
    from adaptiveisp_tpu_torch.ops.bank import make_sharded_render

    out = {}
    for key, shape in inp["sp_meshes"].items():
        mesh = mesh_lib.make_mesh_2d(*shape, device="cpu")
        fn = make_sharded_render(cfg, mesh, inp["sp_names"])
        for name, (img, params) in inp["sp_cases"].items():
            if img.shape[0] % shape[0]:
                continue
            block = mesh_lib.shard_image(mesh, img)
            got = fn(block, mesh_lib.shard_batch(mesh, params),
                     img.shape[1])
            out[(key, name)] = {
                "rows": mesh_lib.data_sharding(mesh, img.shape[0]),
                "bounds": mesh_lib.Rows(mesh, img.shape[1]).bounds,
                "block": got,
                "frames": mesh_lib.gather_rows(mesh, got, img.shape[1])}
        short = np.zeros((shape[0], 4 * shape[1] - 1, 8, 3), np.float32)
        out[(key, "short")] = _refusal(lambda: fn(
            mesh_lib.shard_image(mesh, short),
            mesh_lib.shard_batch(mesh, [p[:shape[0]] for p in params]),
            short.shape[1]))
    return out


def _ep(inp, cfg):
    from adaptiveisp_tpu_torch.ops.ep import make_ep_blend_render

    mesh = mesh_lib.make_mesh_dp_ep(2, 2, device="cpu")
    fn = make_ep_blend_render(cfg.replace(**inp["ep_cfg"]), mesh)
    out = {}
    for name, (img, params, weights) in inp["ep_cases"].items():
        got = fn(mesh_lib.shard_batch(mesh, img),
                 mesh_lib.shard_batch(mesh, params),
                 mesh_lib.shard_batch(mesh, weights))
        out[name] = {"rows": mesh_lib.data_sharding(mesh, img.shape[0]),
                     "out": got}
    out["masking"] = _refusal(lambda: make_ep_blend_render(
        cfg.replace(**inp["ep_cfg"], masking=True), mesh))
    out["indivisible"] = _refusal(lambda: make_ep_blend_render(
        cfg, mesh_lib.make_mesh_dp_ep(1, 4, device="cpu")))
    return out


def _pp(inp, cfg):
    from adaptiveisp_tpu_torch.ops.pp import make_pipelined_render

    mesh = mesh_lib.make_mesh_dp_pp(2, 2, device="cpu")
    frames, params = inp["pp_frames"], inp["pp_params"]
    fn = make_pipelined_render(cfg, mesh, inp["pp_names"])
    rows = mesh_lib.data_sharding(mesh, frames.shape[1])
    got = fn(torch.from_numpy(frames[:, rows]),
             [torch.from_numpy(p) for p in params])
    return {"rows": rows, "out": got,
            "mismatch": _refusal(lambda: make_pipelined_render(
                cfg, mesh, inp["pp_names"] + ["gamma"]))}


def _tp(inp, root):
    from adaptiveisp_tpu_torch import tensor_parallel as tp_lib
    from adaptiveisp_tpu_torch.data.detector_dataset import DetectorDataset
    from adaptiveisp_tpu_torch.detect import train_detector as td
    from adaptiveisp_tpu_torch.detect import train_loop as tl
    from adaptiveisp_tpu_torch.detect.loss import LossHyp
    from adaptiveisp_tpu_torch.detect.model import DetectionModel

    d = inp["tp"]
    mesh = mesh_lib.make_mesh_dp_tp(2, 2, device="cpu")

    def trainer(save_dir=None):
        model = DetectionModel(d["spec"])
        model.load_state_dict(d["weights"])
        tds = DetectorDataset(d["data"], img_size=d["size"],
                              batch_size=len(d["batch"][0]), augment=False,
                              nc=d["spec"]["nc"])
        return tl.DetectorTrainer(model, d["spec"], tds,
                                  cfg=td.DetTrainConfig(**d["cfg"]),
                                  hyp=LossHyp(**d["hyp"]), loggers=False,
                                  save_dir=save_dir, device="cpu", mesh=mesh)

    save = os.path.join(root, "tp_ckpt")
    tr = trainer(save)
    before = tp_lib.state_bytes(tr.state)
    batch = mesh_lib.shard_batch(mesh, tuple(d["batch"]))
    state, res = tr.step_fn(tr.state, *batch)
    out = {"loss": res["loss"].clone(), "bytes": before,
           "bytes_after": tp_lib.state_bytes(state),
           "model": {k: v.clone() for k, v in
                     tr._whole(state.model.state_dict()).items()},
           "ema": {k: v.clone() for k, v in
                   tr._whole(state.ema.params).items()},
           "local": {k: tuple(v.shape) for k, v in
                     state.model.state_dict().items()}}
    tr._save("last.pt", 0, 0.0)
    again = trainer()
    again.resume(os.path.join(save, "last.pt"))
    out["resumed_equal"] = all(
        torch.equal(v, state.model.state_dict()[k])
        for k, v in again.model.state_dict().items()) and all(
        torch.equal(v, state.ema.params[k])
        for k, v in again.state.ema.params.items()) and all(
        torch.equal(again.state.optimizer.state[p]["trace"],
                    state.optimizer.state[q]["trace"])
        for p, q in zip(again.model.parameters(), state.model.parameters()))
    return out


def _setup(root):
    torch.set_num_threads(1)
    return torch.load(os.path.join(root, "inputs.pt"), weights_only=False)


def _write(root, out):
    torch.save(out, os.path.join(root,
                                 f"rank{torch.distributed.get_rank()}.pt"))


def axes_scenarios(root):
    """sp, ep and pp on (2 x 2) meshes (sp also on 1 x 4) and their
    refusals."""
    from adaptiveisp_tpu_torch.config import Config

    inp = _setup(root)
    cfg = Config()
    _write(root, {"sp": _sp(inp, cfg), "ep": _ep(inp, cfg),
                  "pp": _pp(inp, cfg)})


def tp_scenarios(root):
    """The tp step on a (2 x 2) data x model mesh, its checkpoint and
    resume, and an oversubscribed mesh."""
    inp = _setup(root)
    _write(root, {"tp": _tp(inp, root), "oversubscribed": _refusal(
        lambda: mesh_lib.make_mesh_dp_tp(4, 2, device="cpu"))})
