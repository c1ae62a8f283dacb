"""The video morph [EGSR14]: flows, temporal propagation, occlusion and the
warm frame loop (port of ``videomorphing_tpu/video``)."""
