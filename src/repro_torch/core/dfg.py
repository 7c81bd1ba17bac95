"""Loop-body dataflow graphs for mixed integer/FP kernels (COPIFT Step 1).

A :class:`LoopDFG` describes one iteration ("sample") of a kernel loop as a
list of SSA nodes.  Sources may reference values from the same iteration
(lag=0) or carry across iterations (lag>=1, e.g. an LCG state).  Streamed
inputs model SSR-fed operands (no instruction cost; energy is charged to the
consumer, matching Snitch's SSRs).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from .isa import FP_KINDS, INT_DST_FP_KINDS, OpKind, Unit

#: (value name, lag): lag=0 -> this iteration, lag=k -> k iterations ago.
Src = Tuple[str, int]


def s(name: str, lag: int = 0) -> Src:
    return (name, lag)


@dataclass(frozen=True)
class Node:
    name: str                      # produced value (unique within the body)
    kind: OpKind
    srcs: Tuple[Src, ...]
    fn: Optional[Callable[..., Any]] = None
    out: bool = False              # kernel output (must survive transforms)


@dataclass
class LoopDFG:
    """One loop body.  ``inputs`` maps streamed input names to generator
    functions i -> value; ``init`` provides lag-carried initial values.
    """
    name: str
    nodes: List[Node]
    inputs: Dict[str, Callable[[int], Any]] = field(default_factory=dict)
    input_homes: Dict[str, Unit] = field(default_factory=dict)
    init: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        names = [n.name for n in self.nodes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate node names in {self.name}")
        defined = set(names) | set(self.inputs)
        for n in self.nodes:
            for (src, lag) in n.srcs:
                if lag == 0 and src not in defined:
                    raise ValueError(f"{self.name}:{n.name} uses undefined {src}")
                if lag > 0 and src not in names and src not in self.init:
                    raise ValueError(f"{self.name}:{n.name} lagged src {src} has no init")

    # --- Step 1/2: classification ------------------------------------------
    def node_unit(self, node: Node) -> Unit:
        return Unit.FP if node.kind in FP_KINDS else Unit.INT

    def value_home(self, name: str) -> Unit:
        """Which register file a value lives in (drives queue direction)."""
        if name in self.inputs:
            return self.input_homes.get(name, Unit.FP)
        node = self.node(name)
        if node.kind in INT_DST_FP_KINDS:        # FP-executed, integer rd
            return Unit.INT
        return self.node_unit(node)

    def node(self, name: str) -> Node:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(name)

    def consumers(self, name: str, unit: Optional[Unit] = None) -> List[Node]:
        out = []
        for n in self.nodes:
            if any(src == name and lag == 0 for (src, lag) in n.srcs):
                if unit is None or self.consumer_side(n) is unit:
                    out.append(n)
        return out

    def consumer_side(self, node: Node) -> Unit:
        """On which side a node *reads* cross-thread operands.

        FP-unit ops read integer operands from the I2F queue; integer ops
        read FP-homed values from the F2I queue.
        """
        return self.node_unit(node)

    def comm_edges(self) -> List[Tuple[str, Node]]:
        """All (value, consumer) pairs crossing the INT/FP boundary."""
        edges = []
        for n in self.nodes:
            for (src, lag) in n.srcs:
                if lag != 0:
                    continue
                if self.value_home(src) is not self.consumer_side(n):
                    edges.append((src, n))
        return edges

    def outputs(self) -> List[Node]:
        return [n for n in self.nodes if n.out]

    def eval_reference(self, n_samples: int) -> Dict[str, List[Any]]:
        """Pure-Python oracle: evaluate the loop body sequentially."""
        env: Dict[Tuple[str, int], Any] = {}
        outs: Dict[str, List[Any]] = {n.name: [] for n in self.outputs()}
        for i in range(n_samples):
            for name, gen in self.inputs.items():
                env[(name, i)] = gen(i)
            for node in self.nodes:
                args = []
                for (src, lag) in node.srcs:
                    j = i - lag
                    if j < 0:
                        args.append(self.init[src])
                    else:
                        args.append(env[(src, j)])
                if node.fn is None:
                    raise ValueError(f"node {node.name} has no fn")
                env[(node.name, i)] = node.fn(*args)
            for node in self.outputs():
                outs[node.name].append(env[(node.name, i)])
        return outs
