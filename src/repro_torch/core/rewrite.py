"""Pattern-based IR rewriting: ``RewritePattern`` + greedy worklist driver.

This is the MLIR ``applyPatternsAndFoldGreedily`` shape of the optimizer:
each pattern is a local match-and-rewrite anchored on op names, and the
driver keeps a worklist seeded with every op in the region.  All mutation
goes through the ``PatternRewriter``, which both keeps the use-def chains of
``core.ir`` consistent and tells the driver exactly which ops to revisit —
only the ops whose operands changed (plus newly created ops), never a blind
re-walk of the whole region.  Combined with O(#uses) RAUW this replaces the
seed's O(region²) fixpoint sweep.

Erasure is lazy: erased ops are unlinked from the chains immediately and
compacted out of the region op-lists once, when the driver finishes.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Optional, Sequence

from . import ir
from .ir import Operation, Region, Value


class RewritePattern:
    """A local rewrite.  Subclasses set ``ops`` to the anchor op names they
    match (``None`` matches every op) and implement ``match_and_rewrite``,
    returning True iff the IR was changed.  All mutation must go through the
    supplied ``PatternRewriter`` so the driver can track what to revisit.

    ``benefit`` orders patterns tried on the same op (higher first)."""

    ops: Optional[tuple[str, ...]] = None
    benefit: int = 1

    def match_and_rewrite(self, op: Operation, rewriter: "PatternRewriter") -> bool:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__


class RewritePatternSet:
    """A collection of patterns indexed by anchor op name."""

    def __init__(self, patterns: Iterable[RewritePattern] = ()):
        self._by_op: dict[str, list[RewritePattern]] = {}
        self._generic: list[RewritePattern] = []
        self._all: list[RewritePattern] = []
        for p in patterns:
            self.add(p)

    def add(self, pattern: RewritePattern) -> "RewritePatternSet":
        self._all.append(pattern)
        if pattern.ops is None:
            self._generic.append(pattern)
            self._generic.sort(key=lambda p: -p.benefit)
            for lst in self._by_op.values():
                lst.append(pattern)
                lst.sort(key=lambda p: -p.benefit)
        else:
            for name in pattern.ops:
                lst = self._by_op.setdefault(name, list(self._generic))
                lst.append(pattern)
                lst.sort(key=lambda p: -p.benefit)
        return self

    def get(self, opname: str) -> list[RewritePattern]:
        lst = self._by_op.get(opname)
        return lst if lst is not None else self._generic

    def __len__(self) -> int:
        return len(self._all)


class PatternRewriter:
    """The mutation facade handed to patterns.  Every edit updates use-def
    chains (via the ``core.ir`` APIs) and enqueues exactly the ops affected
    by the edit."""

    def __init__(self, driver: "_GreedyDriver"):
        self._driver = driver

    # -- insertion ----------------------------------------------------------
    def insert_before(self, anchor: Operation, op: Operation) -> Operation:
        region = anchor.parent_region
        assert region is not None, "anchor is detached"
        region.insert_before(anchor, op)
        self._driver.enqueue(op)
        return op

    def insert_after(self, anchor: Operation, op: Operation) -> Operation:
        region = anchor.parent_region
        assert region is not None, "anchor is detached"
        region.insert(region.ops.index(anchor) + 1, op)
        self._driver.enqueue(op)
        return op

    def insert_at_start(self, region: Region, op: Operation) -> Operation:
        region.insert(0, op)
        self._driver.enqueue(op)
        return op

    # -- operand mutation ---------------------------------------------------
    def set_operand(self, op: Operation, i: int, v: Value) -> None:
        op.set_operand(i, v)
        self._driver.enqueue(op)

    def set_operands(self, op: Operation, vs: Sequence[Value]) -> None:
        op.operands[:] = list(vs)
        self._driver.enqueue(op)

    def replace_all_uses_with(self, old: Value, new: Value) -> int:
        for user in old.users():
            self._driver.enqueue(user)
        return old.replace_all_uses_with(new)

    # -- replacement / erasure ---------------------------------------------
    def replace_op(self, op: Operation, new_values: Sequence[Value]) -> None:
        """Replace ``op``'s results with ``new_values`` and erase it."""
        assert len(new_values) == len(op.results), (op, new_values)
        for r, nv in zip(op.results, new_values):
            self.replace_all_uses_with(r, nv)
        self.erase_op(op)

    def erase_op(self, op: Operation) -> None:
        """Erase ``op`` lazily: chains update now, the region op-list is
        compacted when the driver finishes."""
        op.drop_all_uses()
        self._driver.notify_erased(op)

    # -- in-place notification ---------------------------------------------
    def notify_modified(self, op: Operation) -> None:
        """Pattern mutated ``op`` in place (opname/attrs): revisit it and
        its users."""
        self._driver.enqueue(op)
        for r in op.results:
            for user in r.users():
                self._driver.enqueue(user)


class _GreedyDriver:
    def __init__(self, region: Region, patterns: RewritePatternSet,
                 max_rewrites: Optional[int] = None):
        self.region = region
        self.patterns = patterns
        self.max_rewrites = max_rewrites
        self.worklist: deque[Operation] = deque()
        self.in_list: set[Operation] = set()
        self.num_rewrites = 0
        self.any_erased = False

    def enqueue(self, op: Operation) -> None:
        # ops whose opname no pattern anchors on can never match: skip them
        # entirely — the driver's constant cost scales with candidate ops,
        # not region size
        if (op is not None and not op.is_erased and op not in self.in_list
                and self.patterns.get(op.opname)):
            self.worklist.append(op)
            self.in_list.add(op)

    def notify_erased(self, op: Operation) -> None:
        self.any_erased = True
        self.in_list.discard(op)

    def run(self) -> int:
        rewriter = PatternRewriter(self)
        get_patterns = self.patterns.get
        seed = [op for op in self.region.walk() if get_patterns(op.opname)]
        self.worklist.extend(seed)
        self.in_list.update(seed)
        worklist, in_list = self.worklist, self.in_list
        while worklist:
            op = worklist.popleft()
            in_list.discard(op)
            if op._dead:
                continue
            for pattern in get_patterns(op.opname):
                if pattern.match_and_rewrite(op, rewriter):
                    self.num_rewrites += 1
                    if (self.max_rewrites is not None
                            and self.num_rewrites >= self.max_rewrites):
                        self._compact(self.region)
                        return self.num_rewrites
                    # re-examine the op itself (unless erased): another
                    # pattern — or the same one again — may now apply
                    self.enqueue(op)
                    break
        if self.any_erased:
            self._compact(self.region)
        return self.num_rewrites

    def _compact(self, region: Region) -> None:
        if any(op.is_erased for op in region.ops):
            region.ops[:] = [op for op in region.ops if not op.is_erased]
        for op in region.ops:
            for r in op.regions:
                self._compact(r)


def apply_patterns_greedily(region: Region, patterns: RewritePatternSet,
                            max_rewrites: Optional[int] = None) -> int:
    """Greedily apply ``patterns`` over ``region`` (recursively) until no
    pattern matches.  Returns the number of rewrites applied."""
    return _GreedyDriver(region, patterns, max_rewrites).run()
