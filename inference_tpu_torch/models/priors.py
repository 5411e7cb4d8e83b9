"""Prior distribution functors (Gaussian, Exponential, Uniform, Joint).

Port of ``inference_tpu.models.priors``:

- ``__call__(theta)`` / ``gradient(theta)`` / ``cost`` / ``cost_gradient``;
- out-of-support log-probability is pinned to ``-1e100``
  (reference: priors.py:358-360, 452-453) with ``torch.where``, so the
  functors work under ``torch.func.vmap`` and ``grad``;
- ``JointPrior`` merges same-type components via ``combine``
  (reference: priors.py:136-143) and checks variable coverage/duplicates;
- ``sample(rng=None)`` draws on the host from a numpy ``Generator``
  (a fresh one when none is given), where the JAX package draws from a
  module-global one.

The parameters live as tensors on an explicit device (default the card)
in ``utils.dtypes.default_float()``.
"""

from abc import ABC, abstractmethod
from itertools import chain
from typing import Iterable, Union
import math

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.dtypes import default_float
from .likelihoods import _as_theta


def _rng(rng):
    return np.random.default_rng() if rng is None else rng


class BasePrior(ABC):
    variables: list

    @staticmethod
    def validate_variable_indices(
        variable_inds: Union[int, Iterable[int]],
        n_parameters: int,
        class_name: str = "BasePrior",
    ) -> list:
        type_err = TypeError(
            f"[ {class_name} error ] 'variable_indices' must be given as an "
            f"integer or list of integers"
        )
        if not isinstance(variable_inds, (int, np.integer, Iterable)):
            raise type_err
        if isinstance(variable_inds, (int, np.integer)):
            variable_inds = [int(variable_inds)]
        variable_inds = list(variable_inds)
        if not all(isinstance(p, (int, np.integer)) for p in variable_inds):
            raise type_err
        variable_inds = [int(p) for p in variable_inds]

        if n_parameters != len(variable_inds):
            raise ValueError(
                f"[ {class_name} error ] The total number of variables specified "
                f"via the 'variable_indices' argument is inconsistent with the "
                f"number specified by the other arguments."
            )
        if len(variable_inds) != len(set(variable_inds)):
            raise ValueError(
                f"[ {class_name} error ] All integers given via 'variable_indices' "
                f"must be unique."
            )
        return variable_inds

    def _place(self, device):
        """The device and dtype of the prior's parameters, and its variable
        indices there."""
        self.device = resolve_device(device, self.__class__.__name__)
        self.dtype = default_float()
        self._zero = torch.zeros((), dtype=self.dtype, device=self.device)
        # the out-of-support log-probability; -inf in float32, as in JAX
        self._outside = torch.tensor(-1e100, dtype=self.dtype, device=self.device)
        self._inds = torch.as_tensor(self.variables, dtype=torch.long, device=self.device)

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    @abstractmethod
    def __call__(self, theta):
        pass

    @abstractmethod
    def gradient(self, theta):
        pass

    def cost(self, theta):
        """Negative prior log-probability."""
        return -self(theta)

    def cost_gradient(self, theta):
        """Gradient of the negative prior log-probability."""
        return -self.gradient(theta)

    def sample(self, rng=None):
        raise NotImplementedError(
            f"[ {self.__class__.__name__} error ] 'sample' is an optional method "
            f"for classes inheriting from 'BasePrior', and has not been "
            f"implemented for '{self.__class__.__name__}'."
        )


class JointPrior(BasePrior):
    """
    Combines multiple prior objects over disjoint variable-index sets into a
    single joint-prior (reference: inference/priors.py:113-227).

    :param components: list of prior objects.
    :param n_variables: total number of model variables.
    """

    def __init__(self, components, n_variables: int):
        if not all(isinstance(c, BasePrior) for c in components):
            raise TypeError(
                "[ JointPrior error ] The sequence passed to 'components' must "
                "contain only instances of BasePrior subclasses."
            )

        # merge components of the same type into single vectorised components
        # (isinstance-based grouping, as the reference does)
        self.components = []
        for cls in (GaussianPrior, ExponentialPrior, UniformPrior):
            group = [c for c in components if isinstance(c, cls)]
            if len(group) == 1:
                self.components.extend(group)
            elif len(group) > 1:
                self.components.append(cls.combine(group))
        known = (GaussianPrior, ExponentialPrior, UniformPrior)
        self.components.extend(c for c in components if not isinstance(c, known))

        self.prior_variables = []
        for var in chain(*[c.variables for c in self.components]):
            if var in self.prior_variables:
                raise ValueError(
                    f"[ JointPrior error ] Variable index '{var}' appears more "
                    f"than once in the prior components."
                )
            self.prior_variables.append(var)

        if len(self.prior_variables) != n_variables:
            raise ValueError(
                f"[ JointPrior error ] The total number of variables specified "
                f"across the prior components ({len(self.prior_variables)}) does "
                f"not match 'n_variables' ({n_variables})."
            )
        if not all(0 <= i < n_variables for i in self.prior_variables):
            raise ValueError(
                "[ JointPrior error ] All specified variable indices must be in "
                "the range [0, n_variables - 1]."
            )

        self.n_variables = n_variables
        self.device = self.components[0].device
        self.dtype = self.components[0].dtype
        self._zero = self.components[0]._zero
        # the components' gradients, concatenated, in variable order
        self._order = torch.as_tensor(
            np.argsort(self.prior_variables), dtype=torch.long, device=self.device
        )

        all_bounds = chain(*[c.bounds for c in self.components])
        all_inds = chain(*[c.variables for c in self.components])
        both = sorted(zip(all_bounds, all_inds), key=lambda x: x[1])
        self.bounds = [v[0] for v in both]

    def __call__(self, theta):
        theta = _as_theta(theta, self._zero)
        return sum(c(theta) for c in self.components)

    def gradient(self, theta):
        theta = _as_theta(theta, self._zero)
        return torch.cat([c.gradient(theta) for c in self.components], dim=-1)[..., self._order]

    def sample(self, rng=None):
        rng = _rng(rng)
        sample = np.zeros(self.n_variables)
        for c in self.components:
            sample[c.variables] = np.asarray(c.sample(rng))
        return sample


class GaussianPrior(BasePrior):
    """
    Gaussian prior over a subset of model variables
    (reference: inference/priors.py:230-313).
    """

    def __init__(self, mean, sigma, variable_indices, device="cuda"):
        mean_arr, sigma_arr = validate_prior_parameters(
            class_name="GaussianPrior",
            params=[("mean", mean), ("sigma", sigma)],
            require_positive={"sigma"},
        )
        self.n_params = mean_arr.size
        self.variables = self.validate_variable_indices(
            variable_indices, self.n_params, "GaussianPrior"
        )
        self._place(device)
        self.mean = self._tensor(mean_arr)
        self.sigma = self._tensor(sigma_arr)
        self.inv_sigma = 1.0 / self.sigma
        self.inv_sigma_sqr = self.inv_sigma**2
        self.normalisation = (
            -torch.log(self.sigma).sum() - 0.5 * math.log(2 * math.pi) * self.n_params
        )
        self.bounds = [(None, None)] * self.n_params

    def __call__(self, theta):
        theta = _as_theta(theta, self._zero)
        z = (self.mean - theta[..., self._inds]) * self.inv_sigma
        return -0.5 * (z**2).sum(dim=-1) + self.normalisation

    def gradient(self, theta):
        theta = _as_theta(theta, self._zero)
        return (self.mean - theta[..., self._inds]) * self.inv_sigma_sqr

    def sample(self, rng=None):
        return _rng(rng).normal(loc=self.mean.cpu().numpy(), scale=self.sigma.cpu().numpy())

    @classmethod
    def combine(cls, priors):
        if not all(isinstance(p, cls) for p in priors):
            raise ValueError(f"All prior objects being combined must be of type {cls}")
        variables = [v for p in priors for v in p.variables]
        means = np.concatenate([p.mean.cpu().numpy() for p in priors])
        sigmas = np.concatenate([p.sigma.cpu().numpy() for p in priors])
        return cls(mean=means, sigma=sigmas, variable_indices=variables, device=priors[0].device)


class ExponentialPrior(BasePrior):
    """
    Exponential prior over a subset of model variables
    (reference: inference/priors.py:316-394).
    """

    def __init__(self, beta, variable_indices, device="cuda"):
        (beta_arr,) = validate_prior_parameters(
            class_name="ExponentialPrior",
            params=[("beta", beta)],
            require_positive={"beta"},
        )
        self.n_params = beta_arr.size
        self.variables = self.validate_variable_indices(
            variable_indices, self.n_params, "ExponentialPrior"
        )
        self._place(device)
        self.beta = self._tensor(beta_arr)
        self.lam = 1.0 / self.beta
        self.normalisation = torch.log(self.lam).sum()
        self.bounds = [(0.0, None)] * self.n_params

    def __call__(self, theta):
        theta = _as_theta(theta, self._zero)
        t = theta[..., self._inds]
        logp = -(self.lam * t).sum(dim=-1) + self.normalisation
        return torch.where((t < 0.0).any(dim=-1), self._outside, logp)

    def gradient(self, theta):
        theta = _as_theta(theta, self._zero)
        t = theta[..., self._inds]
        return torch.where(t >= 0.0, -self.lam, torch.zeros_like(t))

    def sample(self, rng=None):
        return _rng(rng).exponential(scale=self.beta.cpu().numpy())

    @classmethod
    def combine(cls, priors):
        if not all(isinstance(p, cls) for p in priors):
            raise ValueError(f"All prior objects being combined must be of type {cls}")
        variables = [v for p in priors for v in p.variables]
        betas = np.concatenate([p.beta.cpu().numpy() for p in priors])
        return cls(beta=betas, variable_indices=variables, device=priors[0].device)


class UniformPrior(BasePrior):
    """
    Uniform prior over a subset of model variables
    (reference: inference/priors.py:397-489).
    """

    def __init__(self, lower, upper, variable_indices, device="cuda"):
        lower_arr, upper_arr = validate_prior_parameters(
            class_name="UniformPrior", params=[("lower", lower), ("upper", upper)]
        )
        self.n_params = lower_arr.size
        if (upper_arr <= lower_arr).any():
            raise ValueError(
                "[ UniformPrior error ] All values in 'lower' must be less than "
                "the corresponding values in 'upper'"
            )
        self.variables = self.validate_variable_indices(
            variable_indices, self.n_params, "UniformPrior"
        )
        self._place(device)
        self.lower = self._tensor(lower_arr)
        self.upper = self._tensor(upper_arr)
        self.normalisation = -torch.log(self.upper - self.lower).sum()
        self.bounds = [(lo, up) for lo, up in zip(lower_arr, upper_arr)]

    def __call__(self, theta):
        theta = _as_theta(theta, self._zero)
        t = theta[..., self._inds]
        inside = ((self.lower <= t) & (t <= self.upper)).all(dim=-1)
        return torch.where(inside, self.normalisation, self._outside)

    def gradient(self, theta):
        theta = _as_theta(theta, self._zero)
        return torch.zeros_like(theta[..., self._inds])

    def sample(self, rng=None):
        return _rng(rng).uniform(low=self.lower.cpu().numpy(), high=self.upper.cpu().numpy())

    @classmethod
    def combine(cls, priors):
        if not all(isinstance(p, cls) for p in priors):
            raise ValueError(f"All prior objects being combined must be of type {cls}")
        variables = [v for p in priors for v in p.variables]
        lower = np.concatenate([p.lower.cpu().numpy() for p in priors])
        upper = np.concatenate([p.upper.cpu().numpy() for p in priors])
        return cls(lower=lower, upper=upper, variable_indices=variables, device=priors[0].device)


def validate_prior_parameters(class_name, params, require_positive=frozenset()):
    """
    Convert scalar / sequence parameters to 1D float arrays, checking
    finiteness, positivity where required, and equal sizes
    (reference: inference/priors.py:492-563).
    """
    validated = []
    for name, param in params:
        if _convertible(param):
            param = np.atleast_1d(np.asarray(param, dtype=float))
        elif isinstance(param, torch.Tensor):
            param = np.atleast_1d(param.detach().cpu().numpy().astype(float))

        if not isinstance(param, np.ndarray):
            raise TypeError(
                f"[ {class_name} error ] Argument '{name}' should be an array or "
                f"number, but instead has type {type(param)}."
            )
        param = param.astype(float)
        if param.ndim != 1:
            raise ValueError(
                f"[ {class_name} error ] Argument '{name}' should be a 1D array, "
                f"but has {param.ndim} dimensions and shape {param.shape}."
            )
        if not np.isfinite(param).all():
            raise ValueError(
                f"[ {class_name} error ] Argument '{name}' contains non-finite values."
            )
        if name in require_positive and not (param > 0.0).all():
            raise ValueError(
                f"[ {class_name} error ] All values given in '{name}' must be "
                f"greater than zero."
            )
        validated.append(param)

    if len({p.size for p in validated}) != 1:
        raise ValueError(
            f"[ {class_name} error ] Arguments {[n for n, _ in params]} must all "
            f"be arrays of equal size, but have sizes "
            f"{[p.size for p in validated]} respectively."
        )
    return validated


def _convertible(param) -> bool:
    zero_dim = isinstance(param, np.ndarray) and param.ndim == 0
    number = isinstance(param, (int, float, np.integer, np.floating))
    sequence = isinstance(param, (list, tuple)) and all(
        isinstance(v, (int, float, np.integer, np.floating)) for v in param
    )
    return zero_dim or number or sequence
