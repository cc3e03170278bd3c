"""Golden test vectors for DBDE format conformance (the port's own copy of
:mod:`dbde_tpu.golden_vectors`).

Two independent oracles, ported as *data* (not code) from the reference:

1. ``GOLDEN_8x16_*`` — the reference's hand-computed conformance anchor
   (dbde_util_test.cpp:134-178): an 8×16 u8 image whose complete DBDE file
   (28 B video header + 20 B frame header + 80 B frame data) is exactly 128
   known bytes.  Bit-exact in both directions.

2. ``README_10x10_*`` — the worked example from the reference README
   (README.md:69-191): a 10×10 image with ragged edges exercising all three
   partial-tile variants; expected per-tile depths/mins and the 9 payload u64s
   are spelled out in the README.
"""

import numpy as np

GOLDEN_8x16_IMAGE = np.array(
    [
        [0, 1, 9, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
        [8, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17],
        [4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19],
        [6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21],
        [7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22],
        [5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 21],
        [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 18, 20],
        [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 15, 17, 19],
    ],
    dtype=np.uint8,
)

# The complete 128-byte DBDE file for the image above: video header
# (height 8, width 16, 1.0 Hz), frame header (index 1, elapsed 0), frame data
# (2 tiles, depths [4,4], mins [0,8], 8 payload u64s).
GOLDEN_8x16_FILE = bytes(
    [
        3, 0, 0, 0,
        8, 0, 0, 0, 0, 0, 0, 0,
        16, 0, 0, 0, 0, 0, 0, 0,
        0, 0, 0, 0, 0, 0, 0xF0, 0x3F,
        2, 0, 0, 0,
        1, 0, 0, 0, 0, 0, 0, 0,
        0, 0, 0, 0, 0, 0, 0, 0,
        2, 0, 0, 0,
        4, 4,
        2, 0, 0, 0,
        0, 8,
        8, 0, 0, 0,
        0x10, 0x39, 0x54, 0x76,
        0x38, 0x54, 0x76, 0x98,
        0x54, 0x76, 0x98, 0xBA,
        0x76, 0x98, 0xBA, 0xDC,
        0x87, 0xA9, 0xCB, 0xED,
        0x65, 0x87, 0xA9, 0xCB,
        0x43, 0x65, 0x87, 0xA9,
        0x21, 0x43, 0x65, 0x87,
        0x10, 0x32, 0x54, 0x76,
        0x32, 0x54, 0x76, 0x98,
        0x54, 0x76, 0x98, 0xBA,
        0x76, 0x98, 0xBA, 0xDC,
        0x87, 0xA9, 0xCB, 0xED,
        0x65, 0x87, 0xA9, 0xDB,
        0x43, 0x65, 0x87, 0xCA,
        0x21, 0x43, 0x75, 0xB9,
    ]
)
assert len(GOLDEN_8x16_FILE) == 128

README_10x10_IMAGE = np.array(
    [
        [25, 27, 23, 29, 22, 24, 29, 23, 25, 24],
        [22, 24, 21, 25, 22, 27, 28, 21, 27, 26],
        [25, 26, 22, 29, 25, 20, 28, 23, 26, 25],
        [19, 23, 25, 21, 28, 19, 22, 25, 25, 27],
        [27, 25, 30, 28, 25, 23, 27, 26, 24, 24],
        [31, 30, 31, 28, 29, 26, 24, 25, 27, 26],
        [30, 28, 32, 25, 28, 27, 28, 27, 26, 26],
        [29, 31, 31, 32, 29, 29, 25, 22, 24, 25],
        [31, 34, 33, 31, 30, 29, 28, 28, 26, 26],
        [34, 34, 35, 35, 33, 28, 29, 28, 26, 26],
    ],
    dtype=np.uint8,
)

README_10x10_DEPTHS = np.array([4, 2, 3, 0], dtype=np.uint8)
README_10x10_MINS = np.array([19, 24, 28, 26], dtype=np.uint8)

# Payload words verified against the reference *library* (dbde_pack_image,
# compiled at -O0, round-trip clean).  NOTE: the README's hand-computed u64s
# for tile 2 (README.md:170) contain two single-bit errors — its residual
# table at README.md:168 miscopies row 9 col 3 as 6 when the image value 35
# minus the minimum 28 is 7.  The library (and this framework) encode 7.
README_10x10_U64S = [
    0x298362534A53A486,
    0x630926404916A376,
    0x657A9CBC78469B68,
    0x36AADCCA89896D9B,
    0xFFFD5556AAAB0001,
    0x5554AAAAAAAB0000,
    0x5FF6045FF600A773,
    0xF6045FF6045FF604,
    0x045FF6045FF6045F,
]
