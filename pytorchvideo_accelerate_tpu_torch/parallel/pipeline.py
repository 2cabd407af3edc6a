"""Pipeline stages over the model axis (counterpart of the JAX package's
`parallel/pipeline.py`).

A transformer trunk's K homogeneous blocks are cut into P contiguous
stages, one per rank of the stage group: the group of the model-parallel
axis of the one rank grid (`distributed.tensor_group()`: `model` on the
(data, model) train mesh, `tensor` on the library mesh). Stage s owns
blocks [s K/P, (s+1) K/P) and runs only those; the local batch is cut into
M microbatches that stream through the stages.

The port computes the JAX function, not the JAX lowering (a `shard_map` in
which every stage runs a sub-stack on every tick, garbage included). Here
`pipeline_blocks` is one `torch.autograd.Function`:

- forward: a fill-drain schedule of M + P - 1 ticks; at tick t stage s runs
  microbatch t - s when there is one (graphs kept, its input a leaf), then
  each stage that ran hands its activation to the next stage. The last
  stage's output of the whole local batch is broadcast to every stage rank
  (the JAX sum over the stage dim), so the decoder, head and loss run alike
  on every stage rank;
- backward: the same ticks in reverse, each stage's `torch.autograd.grad`
  of its stored outputs against the gradient from the next stage (the
  last stage: the output's gradient), its blocks' gradients summed over the
  microbatches, the input's gradient handed to the previous stage; stage
  0's input gradient of the whole batch is broadcast to every stage rank,
  so the stem's gradient is the same everywhere.

Every rank of the stage group makes the same transfers in the same order,
by construction: which stage sends at a tick is known to all. Over NCCL a
transfer is `batch_isend_irecv` between the two stages; over gloo (which
carries no point-to-point for CUDA tensors) it is one broadcast from the
sender, as `collectives._permute` does.

Gradient sync, the one rule (the JAX module's comment on the over-psum): a
trunk block's gradient is non-zero only on its owner stage (the others
hold zeros of its shape), so it is summed over the stage group and nothing
else is: the stem's, the decoder's and the head's are already equal on
every stage rank. `staged_params` names the trunk leaves; the step's
reduction (`trainer/steps.py reduce_grads`) takes every replicated
gradient's mean over the world and multiplies these by P, which is their
sum over the stage group and their mean over the data axes. Every stage
rank then holds the full gradient and updates to the same parameters, and
rank 0's checkpoint is the whole model, as the JAX package's is.

Without autograd (eval, serving, `torch.no_grad()`) `apply_pipelined_blocks`
runs the plain loop on every rank, the JAX trainer's unpipelined eval twin.

Blocks stay modules, each holding its own parameters, so the model's
parameter tree, checkpoints and converted weights are those of the
unpipelined model; the JAX package's `stack_block_params` and
`unstack_block_params` have no counterpart here.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from pytorchvideo_accelerate_tpu_torch.parallel import mesh as pmesh
from pytorchvideo_accelerate_tpu_torch.parallel.collectives import _broadcast_raw
from pytorchvideo_accelerate_tpu_torch.parallel.distributed import (
    batch_count,
    group_ranks,
    library_coords,
    tensor_count,
    tensor_group,
    tensor_index,
)

# this rank's stage transfers since the last reset (activations and
# gradients handed to the next or previous stage, and the broadcasts of the
# output and of the input's gradient), with their bytes
TRANSFERS = {"sends": 0, "send_bytes": 0, "recvs": 0, "recv_bytes": 0,
             "broadcasts": 0, "broadcast_bytes": 0}


def reset_transfers() -> None:
    for k in TRANSFERS:
        TRANSFERS[k] = 0


@dataclass(frozen=True)
class PipelinePlan:
    """One pipelined trunk execution.

    stages       -- P, equal to the stage axis's size (one stage a rank);
    microbatches -- M, microbatches streamed through the stages a step;
    axis         -- the axis carrying stages ("model" on the train mesh,
                    "tensor" on the library mesh);
    cp_axis      -- the axis ring / Ulysses split tokens over inside the
                    region, when context parallelism composes (library
                    mesh only)."""

    stages: int
    microbatches: int
    axis: str
    cp_axis: Optional[str] = None

    @property
    def active(self) -> bool:
        return self.stages > 1

    def covers(self, n_blocks: int) -> bool:
        """Can this plan cut an `n_blocks` stack into equal stages? (The
        VideoMAE decoder runs unpipelined when its depth does not divide.)"""
        return n_blocks % self.stages == 0


def is_active(plan: Optional[PipelinePlan]) -> bool:
    """A plan that pipelines (None and P = 1 do not)."""
    return plan is not None and plan.active


def analytic_bubble_frac(stages: int, microbatches: int) -> float:
    """Idle fraction of the fill-drain schedule, per direction:
    (P-1)/(M+P-1); 0.0 for P=1."""
    p, m = int(stages), int(microbatches)
    if p <= 1:
        return 0.0
    return (p - 1) / (m + p - 1)


def stage_cuts(n_blocks: int, stages: int) -> List[Tuple[int, int]]:
    """[start, end) block ranges per stage: equal contiguous chunks."""
    if stages < 1:
        raise ValueError(f"pipeline stages must be >= 1, got {stages}")
    if n_blocks % stages:
        raise ValueError(
            f"cannot cut {n_blocks} blocks into {stages} equal pipeline "
            f"stages: {n_blocks} % {stages} != 0 (pick a stage count that "
            "divides the trunk depth)")
    size = n_blocks // stages
    return [(s * size, (s + 1) * size) for s in range(stages)]


def make_plan(shape: tuple, stages: int, microbatches: int = 0,
              accum_steps: int = 1,
              cp_axis_name: Optional[str] = None) -> PipelinePlan:
    """The plan of a run on the mesh `shape` ((data, model) or (data, fsdp,
    tensor, context), `parallel/mesh.py`). `microbatches=0` means auto: the
    accumulation count when accumulation is on, else 2 P. The JAX errors:
    the stage count must equal the stage axis's size, the pipeline and
    context parallelism cannot share the train mesh's one axis, M >= 1."""
    axis = pmesh.model_axis(shape)
    size = dict(zip(pmesh.axis_names(shape), shape))[axis]
    if size != stages:
        raise ValueError(
            f"pipeline_stages={stages} must equal the mesh's {axis!r} axis "
            f"size ({size}): stages are placed one per "
            f"{axis}-slice — set --mesh.model {stages} (train mesh) or "
            f"--mesh.tensor {stages} (library mesh)")
    if cp_axis_name is not None and cp_axis_name == axis:
        raise ValueError(
            "pipeline stages and context parallelism both want the "
            f"{axis!r} axis: on the 2-D train mesh they are mutually "
            "exclusive — use the 4-axis library mesh (tensor=P for "
            "stages, context=C for CP) to compose them")
    m = int(microbatches) or (int(accum_steps) if accum_steps > 1
                              else 2 * int(stages))
    if m < 1:
        raise ValueError(f"pipeline_microbatches must be >= 1, got {m}")
    return PipelinePlan(stages=int(stages), microbatches=m, axis=axis,
                        cp_axis=cp_axis_name)


def _leaves(block) -> List[Tuple[str, tuple, torch.dtype]]:
    return [(n, tuple(p.shape), p.dtype) for n, p in block.named_parameters()]


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def validate_homogeneous_blocks(blocks: Sequence[nn.Module]) -> None:
    """One block function runs every stage, so the blocks' parameter names,
    shapes and dtypes must agree; the first block that differs is named."""
    blocks = list(blocks)
    if not blocks:
        raise ValueError("no blocks to pipeline")
    ref = _leaves(blocks[0])
    for i, b in enumerate(blocks[1:], start=1):
        leaves = _leaves(b)
        if [n for n, _, _ in leaves] != [n for n, _, _ in ref]:
            raise ValueError(
                f"pipeline stages need a homogeneous block stack: block {i}"
                f"'s param tree structure differs from block 0's "
                "(heterogeneous trunks — MViT stage starts, pooled blocks "
                "— cannot stack; see docs/PARALLELISM.md § pipeline)")
        for j, ((_, shape, dtype), (_, rshape, rdtype)) in enumerate(zip(leaves, ref)):
            if (shape, dtype) != (rshape, rdtype):
                raise ValueError(
                    f"pipeline stages need a homogeneous block stack: "
                    f"block {i} leaf #{j} has shape/dtype "
                    f"{shape}/{_dtype_name(dtype)} vs block "
                    f"0's {rshape}/{_dtype_name(rdtype)}")


_WARM = set()


def _warm(group) -> None:
    """NCCL makes a group's communicator at its first collective, in which
    every rank of the group must take part: a one-element all-reduce by
    every stage rank before the first transfer, at which only two stages
    meet (once per group)."""
    if id(group) in _WARM:
        return
    dist.all_reduce(torch.zeros(1, device="cuda"), group=group)
    _WARM.add(id(group))


class _Run:
    """One pipelined call: this rank's stage, its blocks, the stage group."""

    def __init__(self, blocks, plan: PipelinePlan):
        self.stages, self.micro = plan.stages, plan.microbatches
        self.group = tensor_group()
        self.ranks = group_ranks(self.group)
        self.stage = tensor_index()
        lo, hi = stage_cuts(len(blocks), self.stages)[self.stage]
        self.owned = list(blocks[lo:hi])
        self.params = [p for b in blocks for p in b.parameters() if p.requires_grad]
        owned = {id(p) for b in self.owned for p in b.parameters()}
        self.is_owned = [id(p) in owned for p in self.params]
        self.nccl = dist.get_backend(self.group) == "nccl"
        self.ins: List[Optional[torch.Tensor]] = []
        self.outs: List[Optional[torch.Tensor]] = []

    def run_stage(self, h: torch.Tensor) -> torch.Tensor:
        for block in self.owned:
            y = block(h)
            if y.shape != h.shape or y.dtype != h.dtype:
                raise ValueError(
                    f"pipelined block_fn must preserve shape/dtype: "
                    f"{tuple(h.shape)}/{_dtype_name(h.dtype)} -> "
                    f"{tuple(y.shape)}/{_dtype_name(y.dtype)}")
            h = y
        return h

    def hand(self, x: Optional[torch.Tensor], like: torch.Tensor, tick: int,
             step: int) -> Optional[torch.Tensor]:
        """The transfers of one tick: every stage s that ran microbatch tick
        - s hands it to stage s + step (step +1 forward, -1 backward); this
        rank's send is `x`, and what it receives (or None) is returned."""
        senders = [s for s in range(self.stages) if 0 <= tick - s < self.micro
                   and 0 <= s + step < self.stages]
        nbytes = like.numel() * like.element_size()
        got = None
        if self.nccl:
            ops = []
            if self.stage in senders:
                ops.append(dist.P2POp(dist.isend, x.contiguous(),
                                      self.ranks[self.stage + step], self.group))
            if self.stage - step in senders:
                got = torch.empty_like(like)
                ops.append(dist.P2POp(dist.irecv, got,
                                      self.ranks[self.stage - step], self.group))
            if ops:
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
        else:
            for s in senders:
                buf = _broadcast_raw(x if s == self.stage else like, self.ranks[s],
                                     self.group)
                if s == self.stage - step:
                    got = buf
        if self.stage in senders:
            TRANSFERS["sends"] += 1
            TRANSFERS["send_bytes"] += nbytes
        if got is not None:
            TRANSFERS["recvs"] += 1
            TRANSFERS["recv_bytes"] += nbytes
        return got

    def broadcast(self, x: Optional[torch.Tensor], like: torch.Tensor,
                  stage: int) -> torch.Tensor:
        """Stage `stage`'s `x` on every stage rank."""
        TRANSFERS["broadcasts"] += 1
        TRANSFERS["broadcast_bytes"] += like.numel() * like.element_size()
        return _broadcast_raw(x if self.stage == stage else like,
                              self.ranks[stage], self.group)

    def forward(self, x: torch.Tensor, needs_grad: bool) -> torch.Tensor:
        if self.nccl:
            _warm(self.group)
        xm = list(x.split(x.shape[0] // self.micro))
        self.ins, self.outs = [None] * self.micro, [None] * self.micro
        grad = torch.enable_grad() if needs_grad else contextlib.nullcontext()
        h = None
        for tick in range(self.micro + self.stages - 1):
            m, y = tick - self.stage, None
            if 0 <= m < self.micro:
                inp = (xm[m] if self.stage == 0 else h).detach()
                with grad:
                    inp.requires_grad_(needs_grad)
                    y = self.run_stage(inp)
                self.ins[m], self.outs[m] = inp, y
            h = self.hand(y.detach() if y is not None else None, xm[0], tick, 1)
        last = self.stages - 1
        out = (torch.cat([o.detach() for o in self.outs])
               if self.stage == last else None)
        if not needs_grad:
            self.ins, self.outs = [], []
        return self.broadcast(out, x, last)

    def backward(self, gy: torch.Tensor, input_grad: bool) -> tuple:
        gm = list(gy.split(gy.shape[0] // self.micro))
        owned = [p for p, o in zip(self.params, self.is_owned) if o]
        sums: List[Optional[torch.Tensor]] = [None] * len(owned)
        dins = [None] * self.micro
        g = None
        for tick in reversed(range(self.micro + self.stages - 1)):
            m, din = tick - self.stage, None
            if 0 <= m < self.micro:
                gout = gm[m] if self.stage == self.stages - 1 else g
                want_in = self.stage > 0 or input_grad
                targets = ([self.ins[m]] if want_in else []) + owned
                res = torch.autograd.grad(self.outs[m], targets, gout,
                                          allow_unused=True)
                if want_in:
                    din, res = res[0], res[1:]
                for i, r in enumerate(res):
                    if r is not None:
                        sums[i] = r if sums[i] is None else sums[i].add_(r)
                self.ins[m] = self.outs[m] = None
                dins[m] = din
            g = self.hand(din, gm[0], tick, -1)
        dx = None
        if input_grad:
            dx = self.broadcast(torch.cat(dins) if self.stage == 0 else None, gy, 0)
        it = iter(sums)
        grads = []
        for p, o in zip(self.params, self.is_owned):
            s = next(it) if o else None
            grads.append(s if s is not None else torch.zeros_like(p))
        return dx, grads


class _Pipelined(torch.autograd.Function):
    """The pipelined region: `x` and every trunk parameter in, the last
    stage's output on every stage rank out; the backward runs the reverse
    schedule and returns each trunk parameter's gradient (zeros for the
    blocks of other stages) and the input's."""

    @staticmethod
    def forward(ctx, x, run, *params):
        ctx.run = run
        return run.forward(x, needs_grad=True)

    @staticmethod
    def backward(ctx, gy):
        dx, grads = ctx.run.backward(gy.contiguous(), ctx.needs_input_grad[0])
        ctx.run = None
        return (dx, None, *grads)


def pipeline_blocks(blocks: Sequence[nn.Module], x: torch.Tensor,
                    plan: PipelinePlan) -> torch.Tensor:
    """Run `x` (this rank's (B, ...) activations, the same on every stage
    rank) through the homogeneous `blocks` as a P-stage pipeline (module
    docstring); the result is the stack's output, on every stage rank. Each
    block must preserve shape and dtype."""
    blocks = list(blocks)
    stage_cuts(len(blocks), plan.stages)
    width = tensor_count()
    if width != plan.stages:
        raise ValueError(f"plan has {plan.stages} stages but mesh axis "
                         f"{plan.axis!r} is {width}-wide")
    dshards, micro = batch_count(), plan.microbatches
    if x.shape[0] % micro:
        raise ValueError(
            f"global batch {x.shape[0] * dshards} must divide data_shards x "
            f"microbatches = {dshards} x {micro}: each data slice re-slices "
            "its local batch into the pipeline's microbatches")
    validate_homogeneous_blocks(blocks)
    if not plan.active:
        for block in blocks:
            x = block(x)
        return x
    run = _Run(blocks, plan)
    if torch.is_grad_enabled() and (x.requires_grad or run.params):
        return _Pipelined.apply(x, run, *run.params)
    return run.forward(x, needs_grad=False)


def apply_pipelined_blocks(blocks: Sequence[nn.Module], tokens: torch.Tensor,
                           plan: Optional[PipelinePlan], mask=None) -> torch.Tensor:
    """The one dispatch both transformer families share: `blocks` in order,
    through the stage pipeline when `plan` is active and autograd is on,
    else the plain loop (eval runs it on every rank). Each block's own
    `remat` (`models/common.py remat_call`) runs inside its stage. A band
    mask does not pipeline (the JAX error)."""
    if is_active(plan) and torch.is_grad_enabled():
        if mask is not None:
            raise ValueError(
                "attn_mask trunks do not compose with pipeline_stages>1: "
                "the stage scan's per-block fn takes no mask operand (and "
                "the causal band would cross stage cuts) — run the masked "
                "trunk unpipelined, or drop model.attn_mask")
        return pipeline_blocks(blocks, tokens, plan)
    for block in blocks:
        tokens = block(tokens) if mask is None else block(tokens, mask)
    return tokens


def staged_params(model: nn.Module) -> List[str]:
    """Names of the parameters of every pipelined block of `model` (the
    child names its modules' `pipelined_blocks()` return): the gradients
    each stage rank holds in part, summed over the stage group."""
    out = []
    for name, m in model.named_modules():
        for child in getattr(m, "pipelined_blocks", lambda: [])():
            prefix = f"{name}.{child}" if name else child
            out += [f"{prefix}.{n}" for n, _ in m.get_submodule(child).named_parameters()]
    return out


def stage_tag(shape: tuple, ranks: Sequence[int], axis: Optional[str] = None) -> str:
    """Which pipeline stage(s) the processes' `ranks` run on the mesh
    `shape`: "2/4" for one stage, "0-3/4" for a range (the JAX package's
    formatting for the hang watch and trace tags)."""
    axis = axis or pmesh.model_axis(shape)
    pos = pmesh.axis_names(shape).index(axis)
    coords = sorted({library_coords(r, tuple(shape))[pos] for r in ranks})
    total = shape[pos]
    if not coords:
        return f"?/{total}"
    if len(coords) == 1:
        return f"{coords[0]}/{total}"
    return f"{coords[0]}-{coords[-1]}/{total}"
