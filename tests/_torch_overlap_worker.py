"""One rank of the CPU gloo mesh that ``test_torch_overlap.py`` starts.

    python tests/_torch_overlap_worker.py RANK CASE_DIR

Joins four gloo ranks through a file store in CASE_DIR, builds a (1, 2, 2)
context (its tp1 and tp2 groups: rings of 2; the flat TP group: a ring of
4) and runs every case of ``cases.json`` there on this rank's seeded
inputs (``inputs(case, rank)``, which the test also calls): a ring, a
quantized wire or a collective matmul of ``repro_torch.core.overlap``, its
output, and the gradients of ``sum(output * cotangent)`` with a seeded
cotangent of this rank's own, with the collectives it noted.  A case that
must raise records the error.  Writes ``rank{RANK}.npz`` and
``rank{RANK}.json``.  Imports only torch, numpy and the port.
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis import signature
from repro_torch.core import overlap
from repro_torch.core.atp import make_context
from repro_torch.core.mesh import atp_topo

#: the axes a case names: one mesh axis (a ring of 2) or both (of 4)
AXES = {"tp1": "tp1", "tp2": "tp2", "tp": ("tp1", "tp2")}


def inputs(case: dict, rank: int) -> dict:
    """This rank's seeded numpy inputs of ``case``: x, and w where the
    case multiplies, and the cotangent of the output ``ct``."""
    rng = np.random.default_rng(1000 * case["seed"] + rank)
    out = {"x": rng.standard_normal(case["x"]).astype(np.float32)}
    if case.get("w"):
        out["w"] = (rng.standard_normal(case["w"]) / 4).astype(np.float32)
    out["ct"] = rng.standard_normal(case["out"]).astype(np.float32)
    return out


def run(case: dict, rank: int, ctx) -> tuple[dict, dict]:
    axes = AXES[case["axes"]]
    group = ctx.group(axes)
    arr = inputs(case, rank)
    x = torch.from_numpy(arr["x"]).requires_grad_(True)
    w = (torch.from_numpy(arr["w"]).requires_grad_(True) if "w" in arr
         else None)
    op, dim, wire = case["op"], case.get("dim", 0), case.get("wire", "bf16")
    fns = {
        "ring_all_reduce": lambda: overlap.ring_all_reduce(x, group, axes),
        # the pairs the sequence-parallel I/O composes (``atp.seq_gather``)
        "ring_reduce_scatter": lambda: overlap.op(
            x, lambda t: overlap.ring_reduce_scatter_raw(t, group, axes, dim),
            lambda g: overlap.ring_all_gather_raw(g, group, axes, dim)),
        "ring_all_gather": lambda: overlap.op(
            x, lambda t: overlap.ring_all_gather_raw(t, group, axes, dim),
            lambda g: overlap.ring_reduce_scatter_raw(g, group, axes, dim)),
        "quant_psum": lambda: overlap.quant_psum(x, group, axes, wire),
        "quant_ring_all_reduce": lambda: overlap.quant_ring_all_reduce(
            x, group, axes, wire),
        "quant_reduce_scatter": lambda: overlap.quant_reduce_scatter(
            x, group, axes, dim, wire, case.get("ring", False)),
        "overlap_matmul_ar": lambda: overlap.overlap_matmul_ar(
            x, w, group, axes, case.get("chunks", 1), wire_dtype=wire,
            ring=case.get("ring", True)),
        "overlap_matmul_rs": lambda: overlap.overlap_matmul_rs(
            x, w, group, axes, dim),
    }
    if op == "wire_quantize":
        with torch.no_grad():
            q, scale = overlap.wire_quantize(x, group, axes, wire)
        return {"q": q.numpy(), "scale": scale.numpy()}, {}
    meta = {}
    with signature.recording("fwd") as rec:
        try:
            y = fns[op]()
        except ValueError as e:
            return {}, {"error": str(e)}
    leaves = [t for t in (x, w) if t is not None]
    with signature.recording("bwd", rec):
        grads = torch.autograd.grad((y * torch.from_numpy(arr["ct"])).sum(),
                                    leaves)
    meta["fwd"] = [[op_, list(ax), q, n, b] for (_, op_, ax, q), (n, b)
                   in sorted(rec.by_key("fwd").items())]
    meta["bwd"] = [[op_, list(ax), q, n, b] for (_, op_, ax, q), (n, b)
                   in sorted(rec.by_key("bwd").items())]
    out = {"y": y.detach().numpy(), "dx": grads[0].numpy()}
    if w is not None:
        out["dw"] = grads[1].numpy()
    return out, meta


def main(rank: int, case_dir: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{case_dir}/store",
                            rank=rank, world_size=4)
    ctx = make_context(atp_topo(1, 2, 2), boundary_mode="ring",
                       device_type="cpu")
    cases = json.loads((case_dir / "cases.json").read_text())
    arrays, metas = {}, {}
    for case in cases:
        out, meta = run(case, rank, ctx)
        metas[case["name"]] = meta
        arrays.update({f"{case['name']}/{k}": v for k, v in out.items()})
    np.savez(case_dir / f"rank{rank}.npz", **arrays)
    (case_dir / f"rank{rank}.json").write_text(json.dumps(metas))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), Path(sys.argv[2]))
