"""FrechetInceptionDistance (the port of
``torcheval_tpu/metrics/image/fid.py``): streaming feature mean and
covariance sums per distribution, then the eigendecomposition Fréchet
distance.

As in the JAX package, the feature extractor is a constructor argument:
any callable mapping an image batch to ``(N, feature_dim)`` embeddings (a
``torch.nn.Module``, a function).  There is no downloadable InceptionV3
default, so nothing is downloaded.  The extractor runs under
``torch.no_grad()``, so no state holds an autograd graph.  The statistics
are add-mergeable (per-distribution sum, outer-product sum, count), so the
metric syncs like every counter metric."""

import copy
from typing import Callable, Iterable, Tuple

import torch

from torcheval_tpu_torch.metrics._merge import merge_add
from torcheval_tpu_torch.metrics.functional.image._precision import full_f32
from torcheval_tpu_torch.metrics.functional.image.fid import _gaussian_frechet_distance_kernel
from torcheval_tpu_torch.metrics.metric import Metric

_STATES = (
    "real_sum",
    "real_cov_sum",
    "num_real_images",
    "fake_sum",
    "fake_cov_sum",
    "num_fake_images",
)


def _feature_stats(feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    feats = feats.to(torch.float32)
    with full_f32():
        outer = feats.T @ feats
    return feats.sum(dim=0), outer, torch.tensor(float(feats.shape[0]), device=feats.device)


def _mean_cov(
    total: torch.Tensor, cov_sum: torch.Tensor, n: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    mu = total / n
    cov = (cov_sum - n * torch.outer(mu, mu)) / (n - 1.0)
    return mu, cov


class FrechetInceptionDistance(Metric[torch.Tensor]):
    """FID between the real and generated feature distributions seen."""

    def __init__(
        self,
        model: Callable[[torch.Tensor], torch.Tensor],
        *,
        feature_dim: int,
        device=None,
    ) -> None:
        super().__init__(device=device)
        if not callable(model):
            raise ValueError(
                "`model` must be a callable mapping an image batch to "
                "(N, feature_dim) embeddings; there is no downloadable "
                "InceptionV3 default."
            )
        if feature_dim < 1:
            raise ValueError(f"`feature_dim` should be positive, got {feature_dim}.")
        self.model = model
        self.feature_dim = feature_dim
        for prefix in ("real", "fake"):
            self._add_state(f"{prefix}_sum", torch.zeros(feature_dim))
            self._add_state(f"{prefix}_cov_sum", torch.zeros((feature_dim, feature_dim)))
            self._add_state(f"num_{prefix}_images", torch.tensor(0.0))

    # The feature extractor is only needed by update(); compute and merge
    # work from the accumulated statistics alone.  Dropping it from pickles
    # lets the sync toolkit ship FID metrics whether or not the extractor
    # pickles (closures, modules holding device handles, ...).
    def __getstate__(self):
        state = super().__getstate__()
        state["model"] = None
        return state

    # In-process cloning (clone_metric, deepcopy per rank) keeps the
    # extractor: it is shared, and every state is copied.  Only a pickle
    # drops the model.
    def __copy__(self):
        clone = self.__class__.__new__(self.__class__)
        clone.__dict__.update(self.__dict__)
        return clone

    def __deepcopy__(self, memo):
        clone = self.__class__.__new__(self.__class__)
        memo[id(self)] = clone
        for key, value in self.__dict__.items():
            if key in ("model", "_device"):
                clone.__dict__[key] = value
            else:
                clone.__dict__[key] = copy.deepcopy(value, memo)
        return clone

    def update(self, images, *, is_real: bool) -> "FrechetInceptionDistance":
        if self.model is None:
            raise RuntimeError(
                "This FrechetInceptionDistance was deserialized without its "
                "feature extractor (extractors do not ride pickles); assign "
                "`metric.model` before calling update()."
            )
        with torch.no_grad():
            feats = torch.as_tensor(self.model(images)).to(self.device)
            if feats.dim() != 2 or feats.shape[1] != self.feature_dim:
                raise ValueError(
                    "the feature extractor should return shape "
                    f"(num_images, {self.feature_dim}), got {tuple(feats.shape)}."
                )
            total, cov_sum, n = _feature_stats(feats)
        prefix = "real" if is_real else "fake"
        setattr(self, f"{prefix}_sum", getattr(self, f"{prefix}_sum") + total)
        setattr(self, f"{prefix}_cov_sum", getattr(self, f"{prefix}_cov_sum") + cov_sum)
        setattr(self, f"num_{prefix}_images", getattr(self, f"num_{prefix}_images") + n)
        return self

    def compute(self) -> torch.Tensor:
        """FID over everything seen.  Each side needs at least two images
        for an unbiased covariance."""
        for name, n in (("real", self.num_real_images), ("fake", self.num_fake_images)):
            if float(n) < 2:
                raise RuntimeError(
                    f"computing FID requires at least 2 {name} images, got {int(float(n))}."
                )
        mu_r, cov_r = _mean_cov(self.real_sum, self.real_cov_sum, self.num_real_images)
        mu_f, cov_f = _mean_cov(self.fake_sum, self.fake_cov_sum, self.num_fake_images)
        return _gaussian_frechet_distance_kernel(mu_r, cov_r, mu_f, cov_f)

    def merge_state(
        self, metrics: Iterable["FrechetInceptionDistance"]
    ) -> "FrechetInceptionDistance":
        merge_add(self, metrics, *_STATES)
        return self
