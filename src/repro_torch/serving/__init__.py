from .calibrate import (  # noqa: F401
    CalibratedModel,
    Calibration,
    CalibrationConfig,
    calibrate,
    load_calibration,
    save_calibration,
    train_classifier,
)
from .engine import (  # noqa: F401
    BatchedEndpoint,
    BatchStats,
    EdgeBatchServer,
    EndpointStats,
    FrameResult,
    ModelEndpoint,
    OffloadRequest,
    VideoServer,
    degrade_frame,
    make_synthetic_video,
)
