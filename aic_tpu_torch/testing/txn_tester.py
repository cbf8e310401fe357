"""Transaction-law tester (reference:
all-is-cubes/src/transaction/tester.rs TransactionTester).

Port of `aic_tpu/testing/txn_tester.py`, over the port's
`universe.transaction.TransactionConflict`. Systematically checks that a
transaction type obeys the two transaction laws across a set of example
transactions and targets:

1. **check-before-commit**: if `check(target)` passes, `commit` must
   succeed (errors belong in check, never in commit), and the declared
   predicate over (before, after) must hold.
2. **merge completeness**: every pairwise merge that does not raise a
   conflict must have all the effects of both constituents — verified
   by running BOTH constituents' predicates against the merged commit.

Additionally every transaction (including derived merges) must pass
check() on at least one target, so inapplicable test data is flagged.

The tester is protocol-agnostic: the transaction family is duck-typed
(SpaceTransaction.check/commit, UniverseTransaction.check/execute,
InventoryTransaction.check/execute), so the three hooks are injected;
a target whose device state lives on the card takes a `commit` hook
that commits the host half and scatters onto the state.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Callable, Optional

from ..universe.transaction import TransactionConflict


@dataclass
class _Entry:
    txn: Any
    predicate: Callable  # (before, after) -> None, raising AssertionError


class TransactionTester:
    """Set up by chained `.transaction(txn, predicate)` and
    `.target(factory)` calls, then `.test()` (tester.rs's shape).
    Predicates receive a fresh target (before) and the committed one
    (after), and raise on violation."""

    def __init__(
        self,
        check: Optional[Callable] = None,
        commit: Optional[Callable] = None,
        merge: Optional[Callable] = None,
        conflict_types: tuple = (TransactionConflict,),
    ):
        self._entries: list[_Entry] = []
        self._factories: list[Callable] = []
        self._check = check or (lambda txn, target: txn.check(target))
        self._commit = commit or _default_commit
        self._merge = merge or (lambda a, b: a.merge(b))
        self._conflicts = conflict_types

    def transaction(self, txn, predicate) -> "TransactionTester":
        self._entries.append(_Entry(txn, predicate))
        return self

    def target(self, factory) -> "TransactionTester":
        self._factories.append(factory)
        return self

    def _derived(self):
        """Each base transaction plus every successful pairwise merge
        (tester.rs derived_transactions)."""
        for e in self._entries:
            yield e
        for e1, e2 in itertools.product(self._entries, repeat=2):
            try:
                merged = self._merge(e1.txn, e2.txn)
            except self._conflicts:
                continue
            p1, p2 = e1.predicate, e2.predicate

            def both(before, after, p1=p1, p2=p2):
                p1(before, after)
                p2(before, after)

            yield _Entry(merged, both)

    def test(self):
        assert self._entries, "no transactions given"
        assert self._factories, "no targets given"
        for entry in self._derived():
            succeeded = False
            for factory in self._factories:
                before = factory()
                target = factory()
                try:
                    self._check(entry.txn, target)
                except Exception:
                    continue  # inapplicable on this target — allowed
                # Law 1: check passed -> commit must not raise.
                try:
                    after = self._commit(entry.txn, target)
                except Exception as e:  # noqa: BLE001
                    raise AssertionError(
                        f"commit failed after check succeeded: {e!r}\n"
                        f"transaction: {entry.txn!r}"
                    ) from e
                succeeded = True
                entry.predicate(before, after if after is not None else target)
            assert succeeded, (
                f"transaction did not pass check() on any target: {entry.txn!r}"
            )


def _default_commit(txn, target):
    """Default commit hook: prefer `execute`, else `commit`. Our
    transactions mutate the target in place (their return values are
    stats — edit counts, changed slots), so the hook returns None and
    the tester hands predicates the mutated target."""
    if hasattr(txn, "execute"):
        txn.execute(target)
    else:
        txn.commit(target)
    return None
