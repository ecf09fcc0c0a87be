from .dynamics import rk4_step, DoubleIntegrator, DynState, make_dynamics
from .barrier import BarrierFunction, setup_barrier
from .policies import RollPolicy, make_policy
from .klerg import KlergConfig, KlergPlanner, PlannerState
from .target_dists import GaussianMixtureDist, prior_dist
