"""The FCM math, the FCM_S stencil math, the solver core (flat and
stencil problems), the sequential comparator, the mesh-sharded fits and
the deprecated ``fit_*`` adapters, under the JAX package's names."""
from . import (batched, distributed, fcm, histogram,  # noqa: F401
               sequential, solver, spatial, vector_fcm)
from .solver import (BatchedFCMResult, FCMProblem,  # noqa: F401
                     StencilSpec, batch_problems, histogram_problem,
                     pixel_problem, solve, solve_batched, solve_staged,
                     spatial_problem, vector_problem, weighted_center_step)
from .fcm import (FCMConfig, FCMResult, defuzzify, fit_baseline,  # noqa: F401
                  fit_fused, labels_from_centers, objective,
                  update_centers, update_membership)
from .histogram import fit_histogram  # noqa: F401
from .distributed import Mesh, fit_sharded, make_mesh  # noqa: F401
from .batched import (fit_batched,  # noqa: F401
                      fit_batched_pixels, fit_batched_sharded)
from .spatial import SpatialFCMConfig, fit_spatial  # noqa: F401
from .vector_fcm import fit_vector_fcm, fit_vector_batched  # noqa: F401
