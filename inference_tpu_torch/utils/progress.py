"""Progress reporting for long-running sampling loops.

Port of ``inference_tpu.utils.progress``. User-facing output mirrors the
reference ``ChainProgressPrinter``
(reference: inference/mcmc/utilities.py:8-80) — single-line ``\\r`` status
updates with percent/ETA, iteration counts, or countdowns, all disabled via
``display_progress=False`` — but is implemented as a single line-emitter
with small formatting helpers rather than per-mode writer methods.
"""

import sys
from time import time


def _hms(seconds) -> str:
    """``H:MM:SS`` rendering of a duration in seconds."""
    m, s = divmod(int(seconds), 60)
    h, m = divmod(m, 60)
    return f"{h}:{m:02d}:{s:02d}"


def _eta(t_start: float, done: int, total: int) -> int:
    """Remaining seconds estimated from the elapsed-time rate."""
    elapsed = time() - t_start
    return int(elapsed * (total / done - 1)) if done > 0 else 0


class ChainProgressPrinter:
    """
    Emits the chain facades' status lines. All methods are no-ops when
    constructed with ``display=False``.
    """

    def __init__(self, display: bool = True, leading_msg: str = None):
        self.lead = leading_msg or ""
        self.display = display

    def _emit(self, body: str, end: str = ""):
        if self.display:
            sys.stdout.write(f"\r  {self.lead}   [ {body} ]{end}")
            sys.stdout.flush()

    # -- fixed-iteration-count runs ------------------------------------- #
    def iterations_initial(self, total_itr: int):
        if self.display:
            sys.stdout.write("\n")
        self._emit(f"0 / {total_itr} iterations completed")

    def iterations_progress(self, t_start: float, current_itr: int, total_itr: int):
        done = current_itr + 1
        self._emit(
            f"{done} / {total_itr} iterations completed"
            f"  |  ETA: {_eta(t_start, done, total_itr)} sec"
        )

    def iterations_final(self, total_itr: int):
        self._emit(
            f"{total_itr} / {total_itr} iterations completed",
            end="                  \n",
        )

    # -- percentage-of-run displays ------------------------------------- #
    def percent_progress(self, t_start: float, current_itr: int, total_itr: int):
        done = current_itr + 1
        pct = int(100 * done / total_itr)
        self._emit(
            f"{pct}% complete  |  ETA: {_eta(t_start, done, total_itr)} sec",
            end="    ",
        )

    def percent_final(self, t_start: float, total_itr: int):
        self._emit(
            f"complete - {total_itr} steps taken in {_hms(time() - t_start)}",
            end="      \n",
        )

    # -- wall-clock (run_for) countdowns -------------------------------- #
    def countdown_progress(self, t_end, steps_taken):
        self._emit(
            f"{steps_taken} steps taken, time remaining: {_hms(t_end - time())}",
            end="    ",
        )

    def countdown_final(self, run_time, steps_taken):
        self._emit(
            f"complete - {steps_taken} steps taken in {_hms(run_time)}",
            end="      \n",
        )
