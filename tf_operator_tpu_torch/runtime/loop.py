"""Training loop runner: checkpoint/resume, preemption-aware save, profiler.

The port of tf_operator_tpu/runtime/loop.py, the same loop over the port's
train state and profiler:

  - resume-from-latest on start (a recreated pod finds its checkpoint);
  - periodic saves every `save_interval_steps`;
  - preemption-aware save: SIGTERM latches a flag and the loop makes one
    final checkpoint before it returns, so a gang restart loses at most the
    in-flight step, not the save interval;
  - profiler hooks (runtime/profiler.py) + metrics lines on stdout.

`checkpointer` is any object with latest_step(), restore(state),
save(step, state, wait=False) and wait_until_finished(), such as
runtime/train.Checkpointer.
"""
from __future__ import annotations

import signal
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, Optional

from tf_operator_tpu_torch.runtime.profiler import Profiler
from tf_operator_tpu_torch.runtime.train import TrainState
from tf_operator_tpu_torch.utils.logging import get_logger

log = get_logger("runtime.loop")


class PreemptionGuard:
    """Latches SIGTERM/SIGINT so the loop can checkpoint before dying.

    Preemption or maintenance deletes the pod; kubelet delivers SIGTERM
    and waits terminationGracePeriodSeconds — enough for one save. The
    guard only latches a flag; the loop decides when to act (never save
    mid-step)."""

    def __init__(self, install: bool = True) -> None:
        self._preempted = threading.Event()
        self._prev_handlers: Dict[int, Any] = {}
        if install and threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                self._prev_handlers[sig] = signal.signal(sig, self._on_signal)

    def _on_signal(self, signum, frame) -> None:
        log.warning("received signal %s: will checkpoint and stop", signum)
        self._preempted.set()

    def trigger(self) -> None:
        """Test hook / manual preemption injection."""
        self._preempted.set()

    @property
    def preempted(self) -> bool:
        return self._preempted.is_set()

    def uninstall(self) -> None:
        for sig, handler in self._prev_handlers.items():
            signal.signal(sig, handler)
        self._prev_handlers.clear()


@dataclass
class LoopResult:
    state: Any
    steps_run: int
    preempted: bool
    resumed_from: Optional[int]
    last_metrics: Dict[str, float]
    # goodput/MFU split for the session (GoodputTracker.summary()):
    # productive/checkpoint/replay/idle fractions + goodput, mfu when the
    # profiler was given flops_per_step/peak_flops_per_sec
    goodput: Dict[str, float] = field(default_factory=dict)
    # the step the newest durable checkpoint holds on exit (None when no
    # checkpointer / nothing saved).  The elastic-resize drain contract
    # reads this: a SIGTERMed loop's final save must equal the step it
    # actually reached, so the resharded resume loses at most the
    # in-flight step — asserted by the resize soak/loss tests.
    last_saved_step: Optional[int] = None


def run_training(
    state: TrainState,
    train_step: Callable,
    batches: Iterable,
    num_steps: int,
    checkpointer: Optional[Any] = None,
    save_interval_steps: int = 100,
    profiler: Optional[Profiler] = None,
    guard: Optional[PreemptionGuard] = None,
    log_interval_steps: int = 50,
    metrics_sink: Optional[Callable[[str], None]] = None,
) -> LoopResult:
    """Run up to `num_steps` total steps (counting restored progress).

    `batches` yields (inputs, labels) tuples; `train_step(state, *batch)`
    returns (state, metrics). Resume: if `checkpointer` has a saved step,
    restore and continue from there — the recreated pod converges to the
    same loop position (reference semantics: identical pod name/DNS, state
    from the framework's own checkpoint)."""
    profiler = profiler or Profiler()
    profiler.goodput.start()  # wall clock runs from here; restore is replay
    resumed_from = None
    if checkpointer is not None:
        latest = checkpointer.latest_step()
        if latest is not None:
            with profiler.goodput.resume_replay():
                state = checkpointer.restore(state)
            resumed_from = latest
            log.info("resumed from checkpoint step %d", latest)

    guard = guard or PreemptionGuard(install=False)
    step = int(state.step)
    steps_run = 0
    last_saved_step = resumed_from if resumed_from is not None else -1
    last_metrics: Dict[str, float] = {}
    it = iter(batches)

    try:
        try:
            while step < num_steps:
                if guard.preempted:
                    break
                profiler.maybe_trace(step)
                try:
                    batch = next(it)
                except StopIteration:
                    break
                with profiler.step(step):
                    state, metrics = train_step(state, *batch)
                step += 1
                steps_run += 1
                last_metrics = {k: float(v) for k, v in metrics.items()}

                if checkpointer is not None and step % save_interval_steps == 0:
                    with profiler.goodput.checkpoint_save():
                        checkpointer.save(step, state)
                    last_saved_step = step
                if step % log_interval_steps == 0:
                    line = profiler.metrics_line(step, extra=last_metrics)
                    (metrics_sink or (lambda s: log.info("%s", s)))(line)
        finally:
            # flush an unfinished trace window even when a step raises mid-
            # window: leaving the profiler started loses the capture
            profiler.stop_trace()
        preempted = guard.preempted
        if checkpointer is not None and steps_run > 0 and step != last_saved_step:
            # final save unless this exact step is already on disk (interval
            # save this iteration, or a recreated pod that restored an
            # already-complete run) — a checkpointer may refuse duplicates.
            # wait=True: the exit/preemption save must be durable before the
            # process dies, even in async mode
            with profiler.goodput.checkpoint_save():
                checkpointer.save(step, state, wait=True)
            last_saved_step = step
        elif checkpointer is not None:
            # async interval saves may still be in flight; drain before return
            with profiler.goodput.checkpoint_save():
                checkpointer.wait_until_finished()
    finally:
        # the goodput wall clock must freeze on every exit path — a caller
        # reading summary() after a crashed step, or retrying with the same
        # profiler, must not have the downtime charged as idle
        profiler.goodput.stop()
    return LoopResult(
        state=state,
        steps_run=steps_run,
        preempted=preempted,
        resumed_from=resumed_from,
        last_metrics=last_metrics,
        goodput=profiler.goodput.summary(),
        last_saved_step=(
            last_saved_step if checkpointer is not None
            and last_saved_step >= 0 else None
        ),
    )
