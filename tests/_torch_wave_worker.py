"""One rank of the CPU gloo mesh that ``test_torch_wave.py`` starts.

    python tests/_torch_wave_worker.py RANK CASE_DIR

Reads ``case.json`` (the world size, ``max_new``, ``max_seq`` and the
waves: an arch, its layer count and a mesh (dp, d1, d2) each), the JAX
global weights ``{arch}.npz`` and each wave's prompts ``prompts{i}.npy``
from CASE_DIR, joins the gloo group through a file store there, serves each
case's wave through the port's ``launch.serve.serve`` on its mesh, and
writes every case's tokens to ``rank{RANK}.npz``.  Imports only torch,
numpy and the port.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.core.mesh import atp_topo
from repro_torch.launch import serve


def unflatten(flat) -> dict:
    tree: dict = {}
    for key in flat.files:
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = flat[key]
    return tree


def main(rank: int, case_dir: Path) -> None:
    torch.set_num_threads(1)
    case = json.loads((case_dir / "case.json").read_text())
    dist.init_process_group("gloo", init_method=f"file://{case_dir}/store",
                            rank=rank, world_size=case["world"])
    out = {}
    for i, (arch, layers, mesh) in enumerate(case["waves"]):
        cfg = get_config(arch).reduced()
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        # the global tree, as every rank of a job holds it; serve cuts this
        # rank's shard (and consumes the tree)
        params = convert.tree_to_torch(
            unflatten(np.load(case_dir / f"{arch}.npz")))
        prompts = list(np.load(case_dir / f"prompts{i}.npy"))
        out[f"tokens{i}"] = serve.serve(cfg, atp_topo(*mesh), params, prompts,
                                        case["max_new"], case["max_seq"],
                                        device="cpu")
    np.savez(case_dir / f"rank{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), Path(sys.argv[2]))
