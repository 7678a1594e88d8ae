from matchmaker_tpu_torch.metrics.ir_metrics import (
    GLOBAL_METRIC_CONFIG,
    calculate_metrics_plain,
    calculate_metrics_along_candidate_depth,
    calculate_metrics_single_candidate_threshold,
    unrolled_to_ranked_result,
    load_qrels,
    load_ranking,
    print_metric_summary,
)
from matchmaker_tpu_torch.metrics.qa_metrics import squad_exact_match, squad_f1, qa_metric_battery

__all__ = [
    "GLOBAL_METRIC_CONFIG",
    "calculate_metrics_plain",
    "calculate_metrics_along_candidate_depth",
    "calculate_metrics_single_candidate_threshold",
    "unrolled_to_ranked_result",
    "load_qrels",
    "load_ranking",
    "print_metric_summary",
    "squad_exact_match",
    "squad_f1",
    "qa_metric_battery",
]
