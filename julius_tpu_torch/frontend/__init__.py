from julius_tpu_torch.frontend.mfcc import (  # noqa: F401
    FrontendTables,
    build_tables,
    extract_features,
    extract_basic,
)
