"""Alias package: `vo_single_camera_sos_tpu` re-exports the `sosvo` framework.

The canonical package name in this repo is `sosvo` (see SURVEY.md layer map);
this alias keeps the conventional `<reference>_tpu` import path working:

    import vo_single_camera_sos_tpu as vst
    vst.vo.pipeline.run_replay(...)
"""

import sosvo as _sosvo
from sosvo import (  # noqa: F401
    backend,
    calib,
    data,
    dist,
    eval,
    frontend,
    geom,
    geometry,
    sensor,
    synth,
    utils,
    vo,
)

__version__ = _sosvo.__version__
