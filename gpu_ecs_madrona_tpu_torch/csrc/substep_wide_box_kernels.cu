// Kernels 5-9 for all-box tables wider than a box's 8 verts a hull (a
// hand-built or merged object manager whose vert axis is wider): the
// kernels of substep_kernels.cu, built again with their box-plane path
// taking every live vertex of the row at the table's stride and keeping
// the deepest 4 as it reads them (in pairs.py's (depth, index) order), and
// with only their all-box specialisations.  A library of its own, so that
// the 8-vert specialisations there compile as they are and the two build
// side by side.  ops/substep_kernel.py launches these for such tables.
#define SUBSTEP_WIDE_BOX
#include "substep_kernels.cu"
