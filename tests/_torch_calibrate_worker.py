"""One rank of the CPU gloo mesh that ``test_torch_calibrate.py`` starts.

    python tests/_torch_calibrate_worker.py RANK WORLD CASE_DIR

Joins the gloo group through a file store in CASE_DIR and runs the port's
calibration as every rank of a job runs it:

  - ``calibrate_mesh(2, payload_kb=4, repeats=1)`` and
    ``calibrate_mesh(4, payload_kb=8, repeats=1)`` inside an installed
    collective record (which must stay empty: calibration is not a step);
  - ``recalibrate_surviving`` of a tp-4 plan under a deadline, with a
    scripted clock that differs between the ranks: rank 0's advances by
    ``tick`` a reading, the others' stands still, so that a rank deciding
    on its own clock would measure where rank 0 falls back, and hang;
  - ``_time_fn`` on the world group of a call that only the last rank
    makes slow (it sleeps ``straggle_s``): every rank's seconds are the
    slowest rank's;
  - ``launch.train.pick_plan(..., calibrate=True)`` for gpt-m1 at tp 4 on
    the ic3 preset.

Writes each result's JSON form to ``rank{RANK}.json``.  Imports only
torch, numpy and the port.
"""
import json
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.analysis import signature as sig
from repro_torch.configs.registry import get_config
from repro_torch.core import calibrate
from repro_torch.core.calibrate import (CalibEntry, CalibrationTable,
                                        calibrate_mesh, recalibrate_surviving)
from repro_torch.core.plan import ParallelPlan
from repro_torch.launch import train


def main(rank: int, world: int, case_dir: Path) -> None:
    torch.set_num_threads(1)
    case = json.loads((case_dir / "case.json").read_text())
    dist.init_process_group("gloo", init_method=f"file://{case_dir}/store",
                            rank=rank, world_size=world)
    out = {}
    with sig.recording() as rec:
        out["tp2"] = calibrate_mesh(2, payload_kb=4, repeats=1).to_dict()
        out["tp4"] = calibrate_mesh(4, payload_kb=8, repeats=1).to_dict()
    out["recorded"] = len(rec.entries)

    def straggle():
        if rank == world - 1:
            time.sleep(case["straggle_s"])

    out["slowest"] = calibrate._time_fn(straggle, repeats=3,
                                        group=dist.group.WORLD)

    clock = [0.0]

    def timer():
        if rank == 0:
            clock[0] += case["tick"]
        return clock[0]

    old = CalibrationTable(entries=(
        ((4, 1), CalibEntry(b1=10.0, b2=float("inf"))),
        ((2, 2), CalibEntry(b1=9.0, b2=8.0)),
    ), source="measured")
    plan = ParallelPlan(d1=4, d2=1, dp=1, topology="ic3", calibration=old)
    new = recalibrate_surviving(plan, devices=list(range(world)),
                                payload_kb=4, repeats=2,
                                deadline_s=case["deadline_s"], timer=timer)
    out["deadline"] = {"calibration": new.calibration.to_dict(),
                       "provenance": [list(p) for p in new.provenance]}

    res = train.pick_plan(get_config("gpt-m1"), 4, 512, 4, "ic3",
                          calibrate=True)
    out["picked"] = res.best.to_dict()
    (case_dir / f"rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
