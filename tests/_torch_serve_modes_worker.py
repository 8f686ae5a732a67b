"""One rank of the CPU gloo mesh that ``test_torch_speculate.py`` starts.

    python tests/_torch_serve_modes_worker.py RANK CASE_DIR

Reads ``case.json`` (the world size and the cases: a name, an arch, whether
it has an MTP head, a mesh (dp, d1, d2), the server's slots, chunk, page
geometry, modes and ``max_new``), each case's JAX global weights
``{name}.npz`` and prompts ``{name}_prompts.npz`` from CASE_DIR, joins the
gloo group through a file store there, serves each case through the port's
paged server on its mesh, and writes every case's tokens, ticks and stats
to ``rank{RANK}.json``.  Imports only torch, numpy and the port.
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
from repro_torch.models.paging import PagedConfig
from repro_torch.runtime.server import Request, ServerConfig


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
    for c in case["cases"]:
        cfg = dataclasses.replace(get_config(c["arch"]).reduced(),
                                  mtp=c["mtp"])
        params = convert.tree_to_torch(
            unflatten(np.load(case_dir / f"{c['name']}.npz")))
        prompts = np.load(case_dir / f"{c['name']}_prompts.npz")
        scfg = ServerConfig(batch_slots=c["slots"],
                            prefill_chunk=c["chunk"],
                            paged=PagedConfig(**c["geom"]), **c["modes"])
        server, _ = serve.make_paged_server(cfg, scfg, params,
                                            topo=atp_topo(*c["mesh"]),
                                            device="cpu")
        for rid in range(len(prompts.files)):
            server.submit(Request(rid=rid, prompt=prompts[f"p{rid}"],
                                  max_new=c["max_new"]))
        ticks = server.run_until_drained()
        st = server.stats()
        out[c["name"]] = dict(
            tokens={r.rid: [int(t) for t in r.out] for r in server.completed},
            ticks=ticks, **{k: st[k] for k in (
                "spec_drafts", "spec_accepted", "prefix_hit_rate")})
    (case_dir / f"rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), Path(sys.argv[2]))
