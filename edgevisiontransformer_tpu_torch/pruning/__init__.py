"""Head pruning (are16heads) and movement pruning (nn_pruning), port of
``edgevisiontransformer_tpu/pruning/``: the same exports."""

from .apply import mask_heads_params, prune_ffn_params, prune_heads_params  # noqa: F401
from .magnitude_pruners import (  # noqa: F401
    block_prune_mask,
    hybrid_prune_params,
    l1_unstructured_mask,
    ln_smart_structured_mask,
    ln_structured_mask,
    random_unstructured_mask,
)
from .head_importance import calculate_head_importance, head_importance_batch  # noqa: F401
from .policy import (  # noqa: F401
    determine_pruning_sequence,
    load_head_importance_txt,
    parse_head_pruning_descriptors,
    save_head_importance_txt,
    to_pruning_descriptor,
    what_to_prune,
)
