"""Operation and byte counts of the work a cell times, from shapes and
inputs alone, so that a roofline or an ``mfu`` reads the same work
whatever implements it.

``k2_operations`` is ``citylearn_tpu_torch/ops/collect.py``'s
``collect_operation_count`` (through ``ops/battery.py``'s
``operation_count``) at commit 9d3dc9dcb87c1d4e04504b157550827e94518679,
written out: per building-step two curve lookups of ``n_knots`` compares
and 6 arithmetic operations each, 42 other operations, 5 more on a
discharging step, less the 5 of K1's cost and emission sums. ``k2_bytes``
counts K2's inputs read once and its outputs written once, as
``chip_smoke.tensor_bytes`` counted them at that commit. The SAC counts
are the matrix products that the update and the policy need, at 2
operations a multiply-add.
"""

from __future__ import annotations

from typing import Sequence

F32 = 4


def k2_operations(K: int, D: int, B: int, n_knots: int, charging: int) -> int:
    """fp32 operations of one K2 launch of K steps over D districts of B
    buildings, ``charging`` of whose K * D * B actions are >= 0."""
    steps = K * D * B
    return steps * (42 + 2 * (n_knots + 6)) + 5 * (steps - charging) - 5 * steps


def k2_bytes(K: int, D: int, B: int, n_knots: int) -> int:
    """Bytes of one launch: the actions, load and solar streams (K, D, B),
    the battery rows (8, B), four curves (n_knots, B) and the state (D, B)
    x3 in; the rewards (K, D, B) and the state x3 out."""
    return F32 * (3 * K * D * B + 8 * B + 4 * n_knots * B + 3 * D * B + K * D * B + 3 * D * B)


def _macs(sizes: Sequence[int]) -> int:
    return sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))


def policy_forward_flops(A: int, K: int, M: int, hidden: Sequence[int]) -> int:
    """One observation row's policy forward for A agents: the trunk and the
    mean and log-std heads."""
    return 2 * A * (_macs([K, *hidden]) + 2 * hidden[-1] * M)


def sac_update_flops(A: int, K: int, M: int, hidden: Sequence[int], N: int) -> int:
    """One SAC update of A agents on N rows: the next-action sample and
    both target critics; per critic its forward, its weight gradients and
    the input gradients of every layer but the first; the policy's sample,
    both critics' forward and their input gradients back to the action,
    and the policy's weight gradients and input gradients past its first
    layer."""
    q = _macs([K + M, *hidden, 1])
    p = _macs([K, *hidden]) + 2 * hidden[-1] * M
    q_first, p_first = (K + M) * hidden[0], K * hidden[0]
    target = p + 2 * q
    critics = 2 * (q + q + (q - q_first))
    actor = p + 2 * q + 2 * q + p + (p - p_first)
    return 2 * A * N * (target + critics + actor)
