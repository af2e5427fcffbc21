"""A 5×7 ASCII bitmap font (with two rows of descenders) and a renderer
that lays text out at a pixel size with DejaVu Sans's vertical metrics:
the caption images of `utils.image.log_txt_as_img` without PIL.

Each glyph is nine rows of five columns: rows 0–6 stand on the baseline
(capitals and ascenders fill all seven), rows 7–8 hang below it (g, j, p,
q, y, the comma, the semicolon and the underscore). Glyphs missing from the
table (characters outside printable ASCII) advance the pen and draw
nothing.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

_TABLE = r"""
! ..#.. ..#.. ..#.. ..#.. ..#.. ..... ..#..
" .#.#. .#.#. .#.#. ..... ..... ..... .....
# .#.#. .#.#. ##### .#.#. ##### .#.#. .#.#.
$ ..#.. .#### #.#.. .###. ..#.# ####. ..#..
% ##... ##..# ...#. ..#.. .#... #..## ...##
& .##.. #..#. #.#.. .#... #.#.# #..#. .##.#
' ..#.. ..#.. .#... ..... ..... ..... .....
( ...#. ..#.. .#... .#... .#... ..#.. ...#.
) .#... ..#.. ...#. ...#. ...#. ..#.. .#...
* ..... ..#.. #.#.# .###. #.#.# ..#.. .....
+ ..... ..#.. ..#.. ##### ..#.. ..#.. .....
, ..... ..... ..... ..... ..... .##.. ..#.. .#... .....
- ..... ..... ..... ##### ..... ..... .....
. ..... ..... ..... ..... ..... .##.. .##..
/ ..... ....# ...#. ..#.. .#... #.... .....
0 .###. #...# #..## #.#.# ##..# #...# .###.
1 ..#.. .##.. ..#.. ..#.. ..#.. ..#.. .###.
2 .###. #...# ....# ...#. ..#.. .#... #####
3 ##### ...#. ..#.. ...#. ....# #...# .###.
4 ...#. ..##. .#.#. #..#. ##### ...#. ...#.
5 ##### #.... ####. ....# ....# #...# .###.
6 ..##. .#... #.... ####. #...# #...# .###.
7 ##### ....# ...#. ..#.. .#... .#... .#...
8 .###. #...# #...# .###. #...# #...# .###.
9 .###. #...# #...# .#### ....# ...#. .##..
: ..... .##.. .##.. ..... .##.. .##.. .....
; ..... .##.. .##.. ..... .##.. ..#.. .#... ..... .....
< ...#. ..#.. .#... #.... .#... ..#.. ...#.
= ..... ..... ##### ..... ##### ..... .....
> .#... ..#.. ...#. ....# ...#. ..#.. .#...
? .###. #...# ....# ...#. ..#.. ..... ..#..
@ .###. #...# ....# .##.# #.#.# #.#.# .###.
A .###. #...# #...# ##### #...# #...# #...#
B ####. #...# #...# ####. #...# #...# ####.
C .###. #...# #.... #.... #.... #...# .###.
D ###.. #..#. #...# #...# #...# #..#. ###..
E ##### #.... #.... ####. #.... #.... #####
F ##### #.... #.... ####. #.... #.... #....
G .###. #...# #.... #.### #...# #...# .####
H #...# #...# #...# ##### #...# #...# #...#
I .###. ..#.. ..#.. ..#.. ..#.. ..#.. .###.
J ..### ...#. ...#. ...#. ...#. #..#. .##..
K #...# #..#. #.#.. ##... #.#.. #..#. #...#
L #.... #.... #.... #.... #.... #.... #####
M #...# ##.## #.#.# #.#.# #...# #...# #...#
N #...# #...# ##..# #.#.# #..## #...# #...#
O .###. #...# #...# #...# #...# #...# .###.
P ####. #...# #...# ####. #.... #.... #....
Q .###. #...# #...# #...# #.#.# #..#. .##.#
R ####. #...# #...# ####. #.#.. #..#. #...#
S .#### #.... #.... .###. ....# ....# ####.
T ##### ..#.. ..#.. ..#.. ..#.. ..#.. ..#..
U #...# #...# #...# #...# #...# #...# .###.
V #...# #...# #...# #...# #...# .#.#. ..#..
W #...# #...# #...# #.#.# #.#.# #.#.# .#.#.
X #...# #...# .#.#. ..#.. .#.#. #...# #...#
Y #...# #...# #...# .#.#. ..#.. ..#.. ..#..
Z ##### ....# ...#. ..#.. .#... #.... #####
[ .###. .#... .#... .#... .#... .#... .###.
\ ..... #.... .#... ..#.. ...#. ....# .....
] .###. ...#. ...#. ...#. ...#. ...#. .###.
^ ..#.. .#.#. #...# ..... ..... ..... .....
_ ..... ..... ..... ..... ..... ..... ..... ##### .....
` .#... ..#.. ...#. ..... ..... ..... .....
a ..... ..... .###. ....# .#### #...# .####
b #.... #.... #.##. ##..# #...# #...# ####.
c ..... ..... .###. #.... #.... #...# .###.
d ....# ....# .##.# #..## #...# #...# .####
e ..... ..... .###. #...# ##### #.... .###.
f ..##. .#..# .#... ###.. .#... .#... .#...
g ..... ..... .#### #...# #...# #...# .#### ....# .###.
h #.... #.... #.##. ##..# #...# #...# #...#
i ..#.. ..... .##.. ..#.. ..#.. ..#.. .###.
j ...#. ..... ..##. ...#. ...#. ...#. ...#. #..#. .##..
k #.... #.... #..#. #.#.. ##... #.#.. #..#.
l .##.. ..#.. ..#.. ..#.. ..#.. ..#.. .###.
m ..... ..... ##.#. #.#.# #.#.# #...# #...#
n ..... ..... #.##. ##..# #...# #...# #...#
o ..... ..... .###. #...# #...# #...# .###.
p ..... ..... ####. #...# #...# #...# ####. #.... #....
q ..... ..... .#### #...# #...# #...# .#### ....# ....#
r ..... ..... #.##. ##..# #.... #.... #....
s ..... ..... .###. #.... .###. ....# ####.
t .#... .#... ###.. .#... .#... .#..# ..##.
u ..... ..... #...# #...# #...# #..## .##.#
v ..... ..... #...# #...# #...# .#.#. ..#..
w ..... ..... #...# #...# #.#.# #.#.# .#.#.
x ..... ..... #...# .#.#. ..#.. .#.#. #...#
y ..... ..... #...# #...# #...# #...# .#### ....# .###.
z ..... ..... ##### ...#. ..#.. .#... #####
{ ...#. ..#.. ..#.. .#... ..#.. ..#.. ...#.
| ..#.. ..#.. ..#.. ..#.. ..#.. ..#.. ..#..
} .#... ..#.. ..#.. ...#. ..#.. ..#.. .#...
~ ..... ..... .#... #.#.# ...#. ..... .....
"""

ROWS, COLS, ABOVE = 9, 5, 7  # cell rows, columns, rows on the baseline


def _parse(table: str) -> Dict[str, np.ndarray]:
    glyphs = {" ": np.zeros((ROWS, COLS), bool)}
    for line in table.strip("\n").splitlines():
        char, *rows = line.split(" ")
        rows += ["." * COLS] * (ROWS - len(rows))
        glyphs[char] = np.array([[c == "#" for c in r] for r in rows])
    return glyphs


GLYPHS = _parse(_TABLE)

# DejaVu Sans's vertical metrics, in ems: the font the reference renders its
# captions with, so lines of text fall on the same rows
ASCENT, CAP_HEIGHT, LINE_GAP = 1901 / 2048, 1493 / 2048, 4


def line_metrics(size: int):
    """(line pitch, rows from a line's top to its baseline, cap height,
    rows below the baseline, pen advance), in pixels, at `size`."""
    ascent = math.ceil(ASCENT * size)
    cap = max(1, round(CAP_HEIGHT * size))
    return ascent + LINE_GAP, ascent, cap, round(2 * cap / ABOVE), max(1, round(0.6 * size))


def _scaled(glyph: np.ndarray, cap: int, below: int, width: int) -> np.ndarray:
    """A glyph's cell resampled (nearest) to cap + below rows of `width`."""
    rows = [min(ABOVE - 1, dy * ABOVE // cap) for dy in range(cap)]
    rows += [ABOVE + min(ROWS - ABOVE - 1, dy * (ROWS - ABOVE) // below) for dy in range(below)]
    cols = [dx * COLS // width for dx in range(width)]
    return glyph[np.ix_(rows, cols)]


def render_lines(canvas: np.ndarray, lines, size: int) -> None:
    """Draw `lines` into the boolean ink mask `canvas` (H, W) from (0, 0),
    one line every line pitch; ink outside the canvas is dropped."""
    pitch, ascent, cap, below, advance = line_metrics(size)
    width = max(1, round(COLS * cap / ABOVE))
    h, w = canvas.shape
    cache: Dict[str, np.ndarray] = {}
    for k, text in enumerate(lines):
        top = k * pitch + ascent - cap
        for i, ch in enumerate(text):
            glyph = GLYPHS.get(ch)
            x = i * advance
            if glyph is None or x >= w or top >= h:
                continue
            if ch not in cache:
                cache[ch] = _scaled(glyph, cap, below, width)
            g = cache[ch][: h - top, : w - x]
            canvas[top:top + g.shape[0], x:x + g.shape[1]] |= g
