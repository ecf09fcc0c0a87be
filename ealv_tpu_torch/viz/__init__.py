from .plotting import (
    set_mpl_format,
    ExplorationPlotter,
    TrainingPlotter,
    EvalPlotter,
    MultiEvalPlotter,
    BeliefPlotter,
    plot_clusters,
    plot_entropy_slices,
)
from .dashboard import LiveDashboard
