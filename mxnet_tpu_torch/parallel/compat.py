"""``shard_map`` over a mesh (port of ``mxnet_tpu/parallel/compat.py``).

The JAX module resolves whichever ``shard_map`` spelling the installed
JAX provides.  The port has one: :func:`shard_map` places each argument
by its spec (``collectives.shard_tree``), runs ``f`` once per mesh
position of this process in a thread of its own (``collectives.run``;
the collectives inside ``f`` join the positions, and the ranks where the
mesh spans ranks), and assembles the outputs by their specs (a
replicated output is coordinate 0's copy).  On a rank-spanning mesh
every rank calls the mapped function with the same global arguments and
gets the global outputs.  ``check_vma`` is accepted for the JAX
signature and has no effect.
"""
from __future__ import annotations

from ..base import MXNetError
from . import collectives as C

__all__ = ["shard_map", "HAS_SHARD_MAP"]

#: the port always has its shard_map (the JAX package's flag for tests)
HAS_SHARD_MAP = True


def shard_map(f, mesh, in_specs, out_specs, check_vma=True):
    """``f`` over ``mesh``: ``in_specs`` has one spec (or
    spec tree, a prefix of the argument's) an argument, ``out_specs`` is
    the spec (tree) of ``f``'s result.  Arrays may be tensors, numpy
    arrays or :class:`~mxnet_tpu_torch.parallel.collectives.Sharded`
    values already placed by the same spec; other leaves reach every
    position as they are."""
    del check_vma
    specs = tuple(in_specs) if isinstance(in_specs, (list, tuple)) and \
        not isinstance(in_specs, C.P) else (in_specs,)

    def mapped(*args):
        if len(args) != len(specs):
            raise MXNetError("shard_map: %d arguments for %d in_specs"
                             % (len(args), len(specs)))
        with C.chain(mesh):
            placed = [C.shard_tree(a, mesh, s) for a, s in zip(args, specs)]
            per = [[C._part(a, i) for a in placed]
                   for i in range(mesh.size)]
            outs = C.run(mesh, f, per)
            return C.unshard_tree(outs, mesh, out_specs)
    return mapped
