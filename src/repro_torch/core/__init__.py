"""The FCM math, the FCM_S stencil math, the solver core (flat and
stencil problems) and the sequential comparator."""
from . import (batched, fcm, histogram, sequential, solver,  # noqa: F401
               spatial)
from .fcm import (FCMConfig, FCMResult, labels_from_centers,  # noqa: F401
                  update_centers, update_membership)
from .solver import (BatchedFCMResult, FCMProblem,  # noqa: F401
                     StencilSpec, batch_problems, histogram_problem,
                     pixel_problem, solve, solve_batched, solve_staged,
                     spatial_problem, weighted_center_step)
