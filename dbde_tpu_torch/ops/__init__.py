"""Device-side tile codec ops in PyTorch, with the CUDA kernels of the main path.

Same two-phase pipeline as :mod:`dbde_tpu.ops`:

  encode:  tile → per-tile min/depth (kernel K1)
           → exclusive prefix sum of per-tile word counts (``torch.cumsum``)
           → pack every tile at its offset in the frame's stream (kernel K2)
  decode:  offsets from the same prefix sum
           → read each tile's words, unpack, add min, write rows (kernel K3)

A batch whose tiles are all depth 8 has a static stream layout (tile t at
word 16*t): encode phase B and decode then need no scan and run the
uniform pair instead, K4 (``encode_payload_u8``) and K5
(``decode_frames_u8``).  :class:`dbde_tpu_torch.codec.DbdeCodec` chooses
exactly, from the batch's depths.

``tiling``, ``bitpack`` and ``payload`` are the plain PyTorch versions that
run on any device; ``band`` holds the kernel wrappers.
"""

from .tiling import pad_and_tile, untile
from .bitpack import pack_words, tile_depths_mins, unpack_words_to_tiles
from .payload import compact_payload, gather_windows, word_offsets
from .band import (
    LAUNCHES,
    decode_frames,
    decode_frames_u8,
    encode_depths,
    encode_payload,
    encode_payload_u8,
    reset_launches,
)
