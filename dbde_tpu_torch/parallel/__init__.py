"""Sharding of the codec over a mesh of devices (:mod:`.sharding`)."""

from .sharding import (
    Mesh,
    make_mesh,
    mesh_slots,
    visible_devices,
    encode_sharded,
    decode_sharded,
    decode_sharded_dispatch,
    decode_sharded_materialize,
    sharded_roundtrip_step,
    split_payload_host,
    assemble_payload_host,
    assemble_payload_padded,
    segment_slot_words,
    iter_video_sharded,
    read_video_sharded,
    write_video_sharded,
)
