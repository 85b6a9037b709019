from nomalise_kmers_multi_large_tpu.models.diginorm import (  # noqa: F401
    keep_mask_single,
    keep_mask_paired,
)
