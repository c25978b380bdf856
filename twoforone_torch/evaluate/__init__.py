from twoforone_torch.evaluate.metrics import (  # noqa: F401
    js_divergence,
    kl_divergence,
    kl_div_density,
    free_energy_mse,
    get_prob,
    get_torsions,
    normalize_histogram,
)
from twoforone_torch.evaluate.kinetics import (  # noqa: F401
    assign_clusters,
    kmeans_centers,
    tic_state_analysis,
    transition_count_matrix,
    transition_probability_matrix,
)
from twoforone_torch.evaluate.tica import TicaProjection, fit_tica  # noqa: F401
from twoforone_torch.evaluate.evaluators import (  # noqa: F401
    Evaluator,
    DihedralEnergiesEvaluator,
    PwdEvaluator,
    TicEvaluator,
    RmsdEvaluator,
    ContactEvaluator,
    sample_from_model,
)
