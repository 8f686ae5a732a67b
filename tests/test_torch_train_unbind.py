"""The training forward binds each stacked parameter leaf once a step.

``lm._train_forward`` takes each layer's parameters from the
``[count, ...]`` stacks through ``lm._layers``, which unbinds every leaf
once (a zamba leaf once, then once a super-block).  Under autograd each
stacked leaf then has one ``UnbindBackward0``, whose backward stacks the
layers' gradients, and no ``SelectBackward0``: indexing layer by layer
(``lm._layer``) gives each layer a zero-filled copy of the whole stack,
and the L copies are added one by one.

For a dense model (llama3-8b), an MoE one (dbrx-132b, each layer's expert
stack kept whole) and a two-level one (zamba2-7b with two Mamba2 blocks a
super-block and a tail), reduced, on the CPU, with remat on and off: the
graph from ``lm.train_loss`` holds the unbinds it should, and the
gradients equal, bit for bit, those of the old per-layer binding, rebuilt
here by patching ``lm._layers`` to index each layer.  Each slot of the old
zero-filled copies received exactly one layer's gradient plus zeros, which
``stack`` writes unchanged.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.atp import make_context  # noqa: E402
from repro_torch.core.mesh import atp_topo  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402


def _zamba(cfg):
    """Two super-blocks of the shared block and two Mamba2 blocks, then a
    one-block Mamba2 tail: inner stacks of two."""
    return dataclasses.replace(
        cfg, num_layers=7,
        ssm=dataclasses.replace(cfg.ssm, shared_attn_every=3))


CONFIGS = {
    "llama3-8b": lambda c: dataclasses.replace(c, num_layers=3),
    "dbrx-132b": lambda c: dataclasses.replace(c, num_layers=2),
    "zamba2-7b": _zamba,
}
SHAPE = (2, 16)   # (batch, sequence)
TOPO = atp_topo(1, 1, 1)


def _setup(arch, dtype):
    cfg = CONFIGS[arch](get_config(arch).reduced())
    params = lm.shard_params(
        cfg, lm.init_params(cfg, seed=3, dtype=dtype, device="cpu"),
        lm.layout_context(TOPO, 0))
    gen = torch.Generator().manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (SHAPE[0], SHAPE[1] + 1),
                         generator=gen, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].contiguous()}
    return cfg, params, batch


def _loss(cfg, params, batch, remat):
    """``lm.train_loss`` at leaves that require grad: (loss, the leaves)."""
    ctx = make_context(TOPO, device_type="cpu")
    tp = lm.tree_map(lambda t: t.detach().clone().requires_grad_(True),
                     params)
    return lm.train_loss(ctx, cfg, tp, batch, remat=remat), tp


def _consumers(root):
    """Each autograd node reachable from ``root`` -> the nodes that feed
    their gradient into it (by id), and every node by id."""
    into, nodes, todo = {}, {}, [root]
    while todo:
        node = todo.pop()
        if id(node) in nodes:
            continue
        nodes[id(node)] = node
        for child, _ in node.next_functions:
            if child is not None:
                into.setdefault(id(child), []).append(node)
                todo.append(child)
    return into, nodes


def _stacked_leaves(cfg, tp):
    """(name, leaf, levels) of every stacked leaf: levels 2 for a zamba
    super-block's Mamba2 stacks, else 1."""
    out = []
    for i, seg in enumerate(lm.segments(cfg)):
        sp = tp[f"seg{i}"]
        trees = ((sp["mamba"], 2),) if seg.kind == "zamba" else ((sp, 1),)
        for tree, levels in trees:
            for name, leaf in _named(tree, f"seg{i}"):
                out.append((name, leaf, levels))
    return out


def _named(tree, prefix):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}.{k}")
    else:
        yield prefix, tree


def _old_binding(tree, n):
    return [lm._layer(tree, i) for i in range(n)]


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", list(CONFIGS))
def test_each_stacked_leaf_is_unbound_once(arch, remat, monkeypatch):
    """One ``UnbindBackward0`` takes each stacked leaf's gradient, and no
    ``SelectBackward0``; a zamba leaf's is fed by one more unbind a
    super-block.  The old binding, for contrast, feeds each leaf through
    one select a layer."""
    cfg, params, batch = _setup(arch, torch.float32)
    counts = {s.kind: s for s in lm.segments(cfg)}
    for binding in ("unbind", "select"):
        if binding == "select":
            monkeypatch.setattr(lm, "_layers", _old_binding)
        loss, tp = _loss(cfg, params, batch, remat)
        into, nodes = _consumers(loss.grad_fn)
        acc = {id(n.variable): n for n in nodes.values()
               if type(n).__name__ == "AccumulateGrad"}
        stacked = _stacked_leaves(cfg, tp)
        assert stacked
        for name, leaf, levels in stacked:
            users = [type(n).__name__ for n in into[id(acc[id(leaf)])]]
            count = leaf.shape[0]
            if binding == "select":
                assert users == ["SelectBackward0"] * count, (name, users)
                continue
            assert users == ["UnbindBackward0"], (name, users)
            if levels == 2:
                outer = into[id(acc[id(leaf)])][0]
                inner = [type(n).__name__ for n in into[id(outer)]]
                assert inner == ["UnbindBackward0"] * count, (name, inner)
                assert count == counts["zamba"].count
                assert leaf.shape[1] == counts["zamba"].inner - 1 == 2
        if binding == "unbind":
            selects = [n for n in nodes.values()
                       if type(n).__name__ == "SelectBackward0"
                       and any(id(c) in {id(acc[id(leaf)])
                                         for _, leaf, _ in stacked}
                               for c, _ in n.next_functions)]
            assert not selects


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", list(CONFIGS))
def test_gradients_equal_the_per_layer_binding_bit_for_bit(arch, remat,
                                                           dtype,
                                                           monkeypatch):
    """The same loss and every gradient (stacked leaves and the rest)
    equal to the old per-layer binding's, bit for bit."""
    cfg, params, batch = _setup(arch, dtype)

    def grads():
        loss, tp = _loss(cfg, params, batch, remat)
        leaves = adamw.tree_leaves(tp)
        return loss, torch.autograd.grad(loss, leaves)

    loss, got = grads()
    monkeypatch.setattr(lm, "_layers", _old_binding)
    old_loss, want = grads()
    assert torch.equal(loss, old_loss)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert any(g.dtype == dtype for g in got)
