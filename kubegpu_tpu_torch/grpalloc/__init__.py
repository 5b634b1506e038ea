"""The allocation core: the port's copy of the JAX package's ``grpalloc/``
(pure fit/score/take/return logic, no I/O, no Kubernetes dependency).
The rectangle scan is the defining Python loop; the JAX package's
optional C++ twin of it is not ported."""

from kubegpu_tpu_torch.grpalloc.allocator import (
    FitResult,
    GangResult,
    fit_gang,
    pod_fits_group_constraints,
    return_pod_resources,
    take_pod_resources,
)
from kubegpu_tpu_torch.grpalloc.multislice import MultisliceResult, fit_gang_multislice
from kubegpu_tpu_torch.grpalloc.scoring import placement_score
from kubegpu_tpu_torch.grpalloc.treefit import (
    TreeFitResult,
    expand_scalar_request,
    fit_request_tree,
)
from kubegpu_tpu_torch.grpalloc.view import SliceView, build_slice_views

__all__ = [
    "FitResult",
    "GangResult",
    "fit_gang",
    "pod_fits_group_constraints",
    "return_pod_resources",
    "take_pod_resources",
    "MultisliceResult",
    "fit_gang_multislice",
    "placement_score",
    "TreeFitResult",
    "expand_scalar_request",
    "fit_request_tree",
    "SliceView",
    "build_slice_views",
]
