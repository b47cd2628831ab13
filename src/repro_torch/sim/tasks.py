"""CPU inference-task model (paper Table 2).

Every step of the serving workflow lands on the host CPU as a short task;
the paper models these eleven (extended splitwise-sim) and allocates each
a dedicated core via `CPU.assign_core_to_cpu_task`. Durations are
millisecond-scale host work; values are our measured-order-of-magnitude
estimates for a production serving stack (tokenization-adjacent submit
paths are the longest; bookkeeping completions are the shortest).
"""
from __future__ import annotations

import dataclasses

# Table 2 task types -> nominal duration (seconds) on an unaged core.
# Millisecond-scale host work for a production serving stack; the
# tokenization-adjacent submit path and batch assembly dominate.
TASK_DURATIONS_S: dict[str, float] = {
    "submit": 0.020,            # Executor.submit (incl. tokenization path)
    "submit_chain": 0.010,      # Executor.submit_chain
    "submit_flow": 0.0075,      # Executor.submit_flow
    "submit_task": 0.0075,      # Executor.submit_task
    "finish_flow": 0.005,       # Executor.finish_flow
    "finish_request": 0.010,    # Executor.finish_request (detokenize/respond)
    "finish_task": 0.005,       # Executor.finish_task
    "alloc_memory": 0.0125,     # Instance.alloc_memory (KV block tables)
    "free_memory": 0.0075,      # Instance.free_memory
    "start_iteration": 0.015,   # ORCAInstance.start_iteration (batch build)
    "flow_completion": 0.005,   # Link.flow_completion (KV-cache transfer)
}

@dataclasses.dataclass
class CPUTask:
    name: str
    task_id: int

    @property
    def duration_s(self) -> float:
        return TASK_DURATIONS_S[self.name]


class TaskIdAllocator:
    """Per-simulation monotonically increasing CPU-task ids.

    Replaces the old module-global `itertools.count()` +
    `reset_task_ids()` pattern: each `Cluster` / `InferenceEngine` owns
    its own allocator, so concurrently running experiments can never
    interleave ids (the manager's oversubscription FIFO orders waiting
    tasks by id, which requires ids to be per-simulation monotone).
    """

    __slots__ = ("_next",)

    def __init__(self) -> None:
        self._next = 0

    def next_id(self) -> int:
        tid = self._next
        self._next += 1
        return tid

    def new(self, name: str) -> CPUTask:
        return CPUTask(name, self.next_id())
