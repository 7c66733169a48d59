"""The FCM math, the solver core (flat problems) and the sequential
comparator."""
from . import batched, fcm, histogram, sequential, solver  # noqa: F401
from .fcm import (FCMConfig, FCMResult, labels_from_centers,  # noqa: F401
                  update_centers, update_membership)
from .solver import (BatchedFCMResult, FCMProblem,  # noqa: F401
                     batch_problems, histogram_problem, pixel_problem,
                     solve, solve_batched, solve_staged,
                     weighted_center_step)
