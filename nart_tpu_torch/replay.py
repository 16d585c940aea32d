"""Path replay as a kept fwd+bwd machine.

Counterpart of the JAX package's compiled gradient program
(``nart_tpu/grad.py`` ``_balanced_grad_jit``: ``jax.value_and_grad`` over a
``lax.fori_loop`` of rounds, each ``jax.checkpoint``-ed so that only the
traversal outputs are saved).  A ``ReplayMachine`` serves one chunk shape
of one scene, accel and params across calls (the caller keeps it in a
dict, as ``path.trace_balanced`` keeps its forward machines):

  * forward: the work queue's rounds through ``rounds.ReplayRunner``, k to
    each host check (one CUDA graph on the card), each live round writing
    its incoming carry and its traversal outputs into a per-round store on
    the device, at the slot the device count gives it, and adding its loss
    contribution to a device scalar;
  * backward: one round re-run from its slot of the store with the queries
    answered from it, ``torch.autograd.grad`` of the contribution and of
    the outgoing carry's adjoint, the incoming carry's adjoint written to
    static buffers and the parameters' gradients added to static
    accumulators; the runner replays that round once for each live round,
    last to first, with no host read between them.  The first round starts
    from a zero adjoint, so that every round is the same graph.

What a graph may read must stay at one address: the machine copies each
call's trainable leaves into its own leaf tensors (``proxies``, which its
scene holds in their place), and its samples, cot, chunk_base and row_map
into its own buffers.  The tables that the render route derives from the
trainable leaves once per machine (the packed area lights' radiance, the
volume's density cells) are derived inside every round from the proxies,
so each round's gradient reaches the leaves through them as the per-round
replay's does, summed in the same order.  What a call may not change
(geometry, accel, params, shapes) is part of the caller's key.

The store holds capacity + 1 slots: ``n_rounds`` rounds, as the JAX
package's static trip count, and one spare that the rounds past the end
write.  If lanes are still alive when the capacity runs out the call
reports them as ``unfinished`` (its loss and gradient are then not the
full chunk's) and the entry point regrows (grad.py).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .rounds import ReplayRunner, carry_tensors, rebuild
from .scene import map_tensors


def pad_rounds(rounds):
    """A measured round count padded up as the JAX package pads it (to 4
    under 64 rounds, else to 16): fewer regrown stores across chunks."""
    pad = 4 if rounds < 64 else 16
    return int(np.ceil(max(int(rounds), 1) / pad) * pad)


class _Store:
    """Per-round copies of a structure of tensors: slot i of each field in
    a (capacity + 1, ...) tensor, allocated by the first put (the first
    round, which never runs inside a capture)."""

    def __init__(self, capacity):
        self.capacity = capacity
        self.bufs = self.skeleton = None

    def put(self, slot, tree):
        flat = carry_tensors(tree)
        if self.bufs is None:
            self.skeleton = rebuild(tree, itertools.repeat(None))
            self.bufs = [x.new_empty((self.capacity + 1,) + tuple(x.shape))
                         for x in flat]
        for b, x in zip(self.bufs, flat, strict=True):
            b.index_copy_(0, slot, x.unsqueeze(0))

    def get(self, slot):
        return rebuild(self.skeleton,
                       iter([b.index_select(0, slot)[0] for b in self.bufs]))


def _replay_fns(parts, fwd, bwd, store, loss, rays, g, adjoint, wrt, grads):
    """(round_fn, back_fn) of a ReplayRunner.  They hold the machine's
    buffers, never the machine: a cycle through the runner would leave
    its graphs to the cyclic collector (rounds.py)."""
    fwd_round, fwd_tape = fwd
    bwd_round, bwd_tape = bwd

    def round_fn(core, slot):
        out, contrib, seg = fwd_round(core)
        store.put(slot, (core, fwd_tape.record() if fwd_tape else ()))
        loss.add_(contrib)
        if seg is not None:
            rays.add_(seg)
        return out

    def back_fn(slot):
        core, rec = store.get(slot)
        if bwd_tape is not None:
            bwd_tape.answer(rec)
        with torch.enable_grad():
            carry = [x.detach().requires_grad_()
                     for x in parts.adjoint(core[0])]
            out, contrib, _ = bwd_round(
                (parts.with_adjoint(core[0], carry),) + tuple(core[1:]))
            pairs = [(y, a) for y, a in zip(parts.adjoint(out[0]), adjoint)
                     if y.requires_grad]
            res = torch.autograd.grad(
                [contrib] + [y for y, _ in pairs], carry + wrt,
                [g] + [a for _, a in pairs], allow_unused=True)
        for a, r in zip(adjoint, res[:len(carry)]):
            if r is None:
                a.zero_()
            else:
                a.copy_(r)
        for s, r in zip(grads, res[len(carry):]):
            if r is not None:
                s.add_(r)

    return round_fn, back_fn


class ReplayMachine:
    """A replay's kept fwd+bwd machine for one chunk shape (see the
    module's docstring).

    parts is the integrator's side:
      * ``make(scene, samples, chunk_base, row_map, cot_flat, replaying,
        rays)`` -> ``(init, round_, tape)``: init() -> the first carry,
        round_(core) -> (core', loss contribution, rays added, or None where
        the round adds them into ``rays`` itself: the machine's () int64
        count, None for the backward's rounds), tape the round's query
        tape (None where the rounds make no query; replaying answers the
        queries from ``tape.answer``);
      * ``adjoint(state)`` / ``with_adjoint(state, vals)``: the carried
        float tensors that can depend on a trainable leaf.
    max_rounds caps the rounds whatever the capacity (the volume's
    MAX_STEPS: lanes it cuts are not unfinished); graph=False keeps the
    card's rounds eager, one to a check."""

    def __init__(self, parts, scene, leaves, samples_shape, row_map_shape,
                 device, max_rounds=None, graph=True):
        self.parts = parts
        self.max_rounds = max_rounds
        self.graph = graph
        with torch.no_grad():
            self.proxies = [x.detach().to(device).clone().requires_grad_()
                            for x in leaves]
        swap = {id(x): p for x, p in zip(leaves, self.proxies)}
        self.scene = map_tensors(scene, lambda t: swap.get(id(t), t))
        spp_chunk, n_pix = samples_shape
        self.samples = torch.zeros((spp_chunk, n_pix, 2), device=device)
        self.chunk_base = torch.zeros((), dtype=torch.int64, device=device)
        self.row_map = (None if row_map_shape is None else torch.zeros(
            row_map_shape, dtype=torch.int64, device=device))
        self.cot = torch.zeros((spp_chunk * n_pix, 4), device=device)
        bufs = (self.samples, self.chunk_base, self.row_map, self.cot)
        # what the parts build once holds no autograd graph: a graph kept
        # alive would pin the leaves' AccumulateGrad nodes to this stream,
        # and the backward's capture would then have to wait on it
        self.rays = torch.zeros((), dtype=torch.int64, device=device)
        with torch.no_grad():
            self.init, *fwd = parts.make(self.scene, *bufs, False, self.rays)
            _, *bwd = parts.make(self.scene, *bufs, True, None)
        self.rounds_fns = (tuple(fwd), tuple(bwd))
        self.loss = torch.zeros((), device=device)
        self.g = torch.zeros((), device=device)
        with torch.no_grad():
            state = self.init()[0]
        self.adjoint = [torch.zeros_like(x) for x in parts.adjoint(state)]
        self.grads = [torch.zeros_like(x) for x in self.proxies]
        self.runner = None
        self.capacity = 0
        self.calls = 0

    def _regrow(self, capacity):
        """A new store of `capacity` rounds and a runner for it (the old
        graphs go with the old runner)."""
        self.runner = None
        fwd, bwd = self.rounds_fns
        round_fn, back_fn = _replay_fns(
            self.parts, fwd, bwd, _Store(capacity), self.loss, self.rays,
            self.g, self.adjoint, self.proxies, self.grads)
        self.runner = ReplayRunner(round_fn, back_fn, capacity,
                                   k=None if self.graph else 1,
                                   max_rounds=self.max_rounds,
                                   graph=self.graph)
        self.capacity = capacity

    def forward(self, call):
        """The forward of one call (a ReplayCall): its inputs copied in,
        the rounds run into the store.  Returns the loss (a () tensor);
        sets call.rays, rounds and unfinished (the end's one read of the
        device)."""
        with torch.no_grad():
            for p, x in zip(self.proxies, call.leaves, strict=True):
                p.copy_(x)
            self.samples.copy_(call.samples)
            self.cot.copy_(call.cot.reshape(self.cot.shape))
            if torch.is_tensor(call.chunk_base):
                self.chunk_base.copy_(call.chunk_base)
            else:
                self.chunk_base.fill_(call.chunk_base)
            if call.row_map is not None:
                self.row_map.copy_(call.row_map)
            if call.capacity > self.capacity:
                self._regrow(call.capacity)
            self.loss.zero_()
            self.rays.zero_()
            self.runner.run(self.init())
            end = torch.stack([self.rays, self.runner.rounds,
                               self.runner.cut])
            rays, rounds, cut = end.tolist()  # the end's one read
        self.calls += 1
        call.number = self.calls
        call.rays, call.rounds = rays, rounds
        call.unfinished = (cut if self.max_rounds is None
                           or self.capacity < self.max_rounds else 0)
        return self.loss.clone()

    def backward(self, call, g):
        """g * d loss / d leaf for every leaf of the call: the backward
        rounds over the call's store."""
        if call.number != self.calls:
            raise RuntimeError(
                "a later call reused this replay machine before this call's "
                "backward pass: take each call's gradient before the next "
                "call on the same machine")
        with torch.no_grad():
            self.g.copy_(g)
            for a in self.adjoint + self.grads:
                a.zero_()
        self.runner.run_backward(call.rounds)
        return [a.clone() for a in self.grads]


class ReplayCall:
    """One call of a ReplayMachine: its inputs and, after forward(), its
    rays, rounds and unfinished lanes.  The object ReplayLoss takes."""

    def __init__(self, machine, leaves, samples, cot, chunk_base, row_map,
                 capacity):
        self.machine, self.leaves = machine, leaves
        self.samples, self.cot = samples, cot
        self.chunk_base, self.row_map = chunk_base, row_map
        self.capacity = capacity
        self.number = self.rays = self.rounds = self.unfinished = None

    def forward(self):
        return self.machine.forward(self)

    def backward(self, g):
        return self.machine.backward(self, g)


class ReplayLoss(torch.autograd.Function):
    """A replay (an object with forward() -> loss and backward(g) -> the
    leaves' gradients) as one differentiable function of the scene's
    leaves."""

    @staticmethod
    def forward(ctx, replay, *leaves):
        ctx.replay = replay
        return replay.forward()

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return (None, *ctx.replay.backward(g))


def replay_loss(machines, key, build, leaves, samples, cot, chunk_base,
                row_map, n_rounds, measure):
    """sum(cot * la) of one chunk through the machine kept at
    machines[key] (built by build() on first use), with n_rounds as the
    store's capacity: None takes the machine's capacity, or on its first
    call measure() (the forward's round count) padded by pad_rounds.
    Returns (loss, rays, unfinished, rounds)."""
    machine = machines.get(key)
    if machine is None:
        machine = machines[key] = build()
    if n_rounds is None:
        n_rounds = machine.capacity or pad_rounds(measure())
    call = ReplayCall(machine, leaves, samples, cot, chunk_base, row_map,
                      max(int(n_rounds), 1))
    loss = ReplayLoss.apply(call, *leaves)
    return loss, call.rays, call.unfinished, call.rounds
