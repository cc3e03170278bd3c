"""Device-side tile codec ops in PyTorch, with the CUDA kernels of the main path.

Same two-phase pipeline as :mod:`dbde_tpu.ops`:

  encode:  tile → per-tile min/depth (kernel K1)
           → pack every tile at its place in the frame's stream (kernel K2,
             which sums the depths before each block and scans its own)
  decode:  the same places from the depths
           → read each block's words, unpack, add min, write rows (kernel K3)

The plain versions find the places with an exclusive prefix sum of the
per-tile word counts (``payload.word_offsets``).  A batch whose tiles are
all depth 8 has a static stream layout (tile t at word 16*t): encode phase
B and decode then need no depths and run the uniform pair instead, K4 (``encode_payload_u8``) and K5
(``decode_frames_u8``).  :class:`dbde_tpu_torch.codec.DbdeCodec` chooses
exactly, from the batch's depths.

The tiles backend moves the frames into a word-major tile layout
(``tile_layout.image_to_tiles_w``) and runs one fused encode, K6
(``encode_tiles``: depths, minima, an in-kernel scan and the pack), and
one decode, K7 (``decode_tiles``), then moves the tiles back.

``tiling``, ``bitpack`` and ``payload`` are the plain PyTorch versions that
run on any device; ``band`` and ``tile_layout`` hold the kernel wrappers,
and ``launch`` their shared launch counts and checks.
"""

from .tiling import pad_and_tile, untile
from .bitpack import pack_words, tile_depths_mins, unpack_words_to_tiles
from .payload import compact_payload, gather_windows, word_offsets
from .launch import LAUNCHES, reset_launches
from .band import (
    decode_frames,
    decode_frames_u8,
    encode_depths,
    encode_payload,
    encode_payload_u8,
)
from .tile_layout import decode_tiles, encode_tiles, image_to_tiles_w, tiles_w_to_image
