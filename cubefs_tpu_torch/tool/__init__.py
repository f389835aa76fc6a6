"""Operator and benchmark tools of the port (the counterparts of
``cubefs_tpu/tool``): the volume snapshot, the automount helper, the
traffic model, and the codec, scrub and tiering A/B benches."""
