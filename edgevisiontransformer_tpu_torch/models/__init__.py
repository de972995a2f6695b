from .vit import (  # noqa: F401
    ViT,
    deit_config,
    encoder_segments,
    fused_vit_apply,
    get_deit_base,
    get_deit_small,
    get_deit_tiny,
    prepare_vit_fused,
)
