"""Readings that the limits of ``correct`` are set from, on the card:

    python benchmark/control.py --workload NAME --seeds 1 2 3 \
        [--sides program control]

For each seed, ``program`` serves the cell's checked batches through the
port and ``control`` through the plain reference one precision lower than
the configuration states (TF32 for float32 with TF32 off); each is judged
by the reference at full precision, as a run judges its window.  For
training, ``--faults`` also drives the trainer under faults planted in the
program (``benchmark/faults.py``).  One JSON line per seed and side.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402


def served_by_program(cell, seed, device):
    from benchmark import devices, precision
    from benchmark.drivers import infer

    tr = cell.traffic
    precision.program(cell.config["precision"]["infer"])
    agent_sd, det_sd = infer.weights(cell, device)
    isp, det = infer.build_program(cell, agent_sd, det_sd, device)
    del agent_sd, det_sd
    pool = infer.scene_pool(cell, seed, device)
    plan = infer.Plan(seed, pool.shape[0] // int(tr["batch"]))
    warm = int(tr["warmup_units"])
    for k in range(warm):
        infer.served_unit(isp, det, pool, plan, k, tr, device)
    kept = {}
    for k in infer.check_units(seed, warm, tr):
        res, dets, n_valid = infer.served_unit(isp, det, pool, plan, k, tr,
                                               device)
        kept[k] = (res.selected, res.params, res.image, dets, n_valid)
    del isp, det
    gc.collect()
    devices.free(device)
    return pool, plan, kept


def served_by_control(cell, seed, device):
    from benchmark import devices, precision
    from benchmark.drivers import infer
    from benchmark.reference import models as ref

    tr, cfg_file = cell.traffic, cell.config
    agent_sd, det_sd = infer.weights(cell, device)
    agent = ref.agent(cfg_file, agent_sd, device)
    detector = ref.detector(cfg_file, det_sd, device)
    spec = ref.spec(cfg_file)
    pool = infer.scene_pool(cell, seed, device)
    plan = infer.Plan(seed, pool.shape[0] // int(tr["batch"]))
    steps, b = int(cfg_file["agent_config"]["test_steps"]), int(tr["batch"])
    kept = {}
    with precision.control():
        for k in infer.check_units(seed, int(tr["warmup_units"]), tr):
            s = plan.slot(k)
            x = pool[s * b:(s + 1) * b].to(device)
            res = ref.adaptive_rollout(agent, x, steps, plan.noise_seed(k),
                                       tr["render"])
            dets, n_valid = ref.detect(detector, res.image, tr["nms"], spec)
            kept[k] = (res.selected, res.params, res.image,
                       dets.cpu().numpy(), n_valid.cpu().numpy())
    del agent, detector
    gc.collect()
    devices.free(device)
    return pool, plan, kept


SIDES = {"program": served_by_program, "control": served_by_control}


@contextlib.contextmanager
def half_batch_fault():
    """The reference in the program's place with half of each batch left
    out of the detector loss, the mean over the rest in its place."""
    from benchmark import faults, precision
    from benchmark.reference.train import step

    with faults.half_batch_loss(step), precision.reference():
        yield


def _control():
    from benchmark import precision

    return precision.control()


# stand-ins: the reference in the program's place, judged as the program is
STAND_INS = {"control": _control, "half_batch_ref": half_batch_fault}


def train_readings(cell, seed: int, device, stand_ins, planted):
    """The served trainer's first steps judged by the reference, then the
    same draws with each stand-in in the program's place, then the
    trainer's first steps again under each planted fault of
    ``benchmark/faults.py``, each judged the same way."""
    import shutil

    from benchmark import devices, faults
    from benchmark.drivers import train
    from benchmark.traffic.dataset import data_root

    root = data_root(cell.name)
    runs = [("program", contextlib.nullcontext)] + [
        (name, faults.TRAIN[name]) for name in planted]
    out = []
    for side, plant in runs:
        try:
            t0 = time.perf_counter()
            with plant():
                trainer, rec, served = train.first_steps(cell, seed, device,
                                                         root)
            trainer.close()
            del trainer
            gc.collect()
            devices.free(device)
            judged = [(side, None)]
            if side == "program":
                judged += [(n, STAND_INS[n]) for n in stand_ins]
            for name, stand_in in judged:
                numbers, _ = train.reference_numbers(
                    cell, seed, rec.drawn(), served, device,
                    stand_in=stand_in)
                out.append({"cell": cell.name, "seed": seed, "side": name,
                            "numbers": numbers,
                            "losses": [s["losses"] for s in rec.steps],
                            "seconds": time.perf_counter() - t0})
                print(json.dumps(out[-1]), flush=True)
            del rec, served
            gc.collect()
            devices.free(device)
        finally:
            shutil.rmtree(root, ignore_errors=True)
    return out


def readings(cell, seed: int, side: str, device):
    import torch

    from benchmark.drivers import infer

    t0 = time.perf_counter()
    pool, plan, kept = SIDES[side](cell, seed, device)
    numbers, _ = infer.reference_numbers(cell, seed, pool, plan, kept,
                                         device)
    chosen = torch.cat([v[0].flatten().cpu() for v in kept.values()])
    return {"cell": cell.name, "seed": seed, "side": side,
            "numbers": numbers, "seconds": time.perf_counter() - t0,
            "selections": torch.bincount(chosen.long() + 1).tolist()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--sides", nargs="+", default=None,
                   help="inference: program, control; training: the "
                   "stand-ins control, half_batch_ref (default: all)")
    p.add_argument("--faults", nargs="*", default=[],
                   help="training: faults of benchmark/faults.py planted "
                   "in the program, each a run of its own")
    p.add_argument("--fault-seeds", type=int, default=None,
                   help="plant the faults on the first N seeds only")
    args = p.parse_args(argv)
    harness.set_cache_env()
    import torch

    cell = harness.find_cell(harness.load_benchmark(), args.workload)
    device = torch.device("cuda")
    for i, seed in enumerate(args.seeds):
        if cell.traffic["kind"] == "train":
            planted = (args.faults if args.fault_seeds is None
                       or i < args.fault_seeds else [])
            train_readings(cell, seed, device,
                           args.sides or list(STAND_INS), planted)
            continue
        for side in args.sides or list(SIDES):
            print(json.dumps(readings(cell, seed, side, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
