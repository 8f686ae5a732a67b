"""One rank of the four-rank gloo job that ``test_torch_elastic.py``
starts.

    python tests/_torch_elastic_worker.py RANK WORLD WORK

Joins the gloo group through a file store in WORK (``launch.chaos_smoke.
rank_main``) and runs ``launch.chaos_smoke.elastic_run`` as the case in
``WORK/case.json`` says: the reference's plan (JSON) and its global
weights (``.npz``), 4 simulated hosts of one rank each, the case's faults
(a transient one at step 3, hosts 2 and 3 lost at step 5), the
recalibration's benchmark replaced by a table of entries.
Ranks 2 and 3 leave; ranks 0 and 1 write their losses, the re-planned
plan's JSON and their counters to ``WORK/shrink{RANK}.json``.  Imports
only torch, numpy and the port.
"""
import sys
from pathlib import Path

from repro_torch.configs.base import ModelConfig
from repro_torch.core.calibrate import CalibEntry
from repro_torch.core.plan import ParallelPlan
from repro_torch.launch import chaos_smoke
from repro_torch.runtime.faults import FaultPlan


def shrink(rank, world, work, case) -> dict:
    cfg = ModelConfig(**case["cfg"])
    table = {tuple(map(int, k.split(","))): CalibEntry.from_dict(v)
             for k, v in case["measure"].items()}
    tr, live, fabric, losses = chaos_smoke.elastic_run(
        cfg, ParallelPlan.from_dict(case["plan"]), str(work / "ckpt"), work,
        rank=rank, n_hosts=4, fplan=FaultPlan.from_dict(case["faults"]),
        measure=lambda d1, d2: table[(d1, d2)],
        init_params=lambda: chaos_smoke.global_params(cfg, case))
    return {"losses": losses, "plan": live["plan"].to_dict(),
            "replans": tr.replans, "total_failures": tr.total_failures,
            "failures": tr.failures,
            "epochs": {str(e): sorted(v) for e, v in fabric.epochs().items()}}


if __name__ == "__main__":
    chaos_smoke.rank_main({"shrink": shrink}, "shrink", int(sys.argv[1]),
                          int(sys.argv[2]), Path(sys.argv[3]))
