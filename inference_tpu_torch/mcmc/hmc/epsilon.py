"""Host-side view of the HMC step-size adaptation state.

Port of ``inference_tpu.mcmc.hmc.epsilon``. The on-device adaptation
itself lives in the batched transition
(``inference_tpu_torch.mcmc._kernels.hmc`` via ``common.AdaptiveScale``); this
module provides a small host container used for diagnostics and ``.npz``
(de)serialisation with the same key layout as the reference
``EpsilonSelector`` (reference: inference/mcmc/hmc/epsilon.py:5-68).
"""

import numpy as np

from .._kernels.hmc import EPS_TARGET, EPS_CHK_INT, EPS_GROWTH


class EpsilonSelector:
    """
    Host mirror of the device epsilon-adaptation state. ``epsilon_values`` /
    ``epsilon_checks`` record the step-size history (value after each
    adjustment, and the chain step at which it was assessed) for the
    diagnostics plots and burn-in estimation.
    """

    def __init__(self, epsilon: float):
        self.epsilon = float(epsilon)
        self.epsilon_values = [float(epsilon)]
        self.epsilon_checks = [0.0]
        self.avg = 0.0
        self.var = 0.0
        self.num = 0.0
        self.accept_rate = EPS_TARGET
        self.chk_int = EPS_CHK_INT
        self.growth_factor = EPS_GROWTH

    def record_trace(self, epsilons: np.ndarray, start_step: int):
        """
        Absorb a per-step epsilon trace produced by a chunk of steps, detecting
        the steps at which the value changed.
        """
        eps = np.asarray(epsilons, dtype=float)
        if eps.size == 0:
            return
        prev = self.epsilon
        for i, e in enumerate(eps):
            if e != prev:
                self.epsilon_values.append(float(e))
                self.epsilon_checks.append(float(start_step + i))
                prev = float(e)
        self.epsilon = float(eps[-1])

    def sync_counters(self, avg, var, num, chk_int):
        """Mirror the device adaptation counters (for checkpointing)."""
        self.avg = float(avg)
        self.var = float(var)
        self.num = float(num)
        self.chk_int = int(chk_int)

    def get_items(self) -> dict:
        return {
            "epsilon": self.epsilon,
            "epsilon_values": self.epsilon_values,
            "epsilon_checks": self.epsilon_checks,
            "avg": self.avg,
            "var": self.var,
            "num": self.num,
            "accept_rate": self.accept_rate,
            "chk_int": self.chk_int,
            "growth_factor": self.growth_factor,
        }

    def load_items(self, dictionary):
        self.epsilon = float(dictionary["epsilon"])
        self.epsilon_values = list(dictionary["epsilon_values"])
        self.epsilon_checks = list(dictionary["epsilon_checks"])
        self.avg = float(dictionary["avg"])
        self.var = float(dictionary["var"])
        self.num = float(dictionary["num"])
        self.accept_rate = float(dictionary["accept_rate"])
        self.chk_int = int(dictionary["chk_int"])
        self.growth_factor = float(dictionary["growth_factor"])
