"""Operations and bytes of one launch of the kernels a roofline metric
reads, counted from the shapes (frozen here so that a change to the
program cannot move the yardstick).

* K2, exact n-body repulsion over n nodes: per ordered pair dx, dy; dx²+dy²;
  the ε clamp; the square root; with radii d − r_i − r_j and its clamp;
  m_i·m_j; eff·d; the divide; and the two multiply-adds into the force:
  17 operations with radii, 15 without. Bytes: positions, masses (and
  radii) read and the forces written once, 4 bytes an element.
* K5, monopole far field of n nodes against C cells: per (node, cell) pair
  dx, dy; the squares and their sum; the clamp; ·M; the divide; the
  own-cell select; the two products and the two adds: 13. Bytes: 16 a node
  read (position, mass, cell), 8 a node written, 12 a cell read.
"""


def k2(n: int, radii: bool) -> tuple[int, int]:
    return (17 if radii else 15) * n * n, n * 4 * (5 + int(radii))


def k5(n: int, cells: int) -> tuple[int, int]:
    return 13 * n * cells, n * 24 + cells * 12
