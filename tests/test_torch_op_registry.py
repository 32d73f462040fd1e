"""The port registers every op the JAX package registers: the same names
(298 with the aliases, 201 canonical ops), each name on the same
canonical op with the same aliases, input names, aux names, number of
outputs and output names, and the same attributes accepted (the
lowering functions' private ``_``-named defaults aside)."""
import pytest

from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg
import mxnet_tpu  # noqa: F401 — registers the JAX package's ops
import mxnet_tpu_torch  # noqa: F401 — registers the port's ops

J, T = jreg.OP_REGISTRY, treg.OP_REGISTRY

#: attribute sets under which an op's callable names and counts are read
#: (``Proposal``'s outputs, ``FullyConnected``'s bias, ``RNN``'s states,
#: the variable-input ops' ``num_args``)
ATTR_SETS = ({}, {"output_score": True}, {"no_bias": True},
             {"mode": "lstm", "state_outputs": True}, {"num_args": 3},
             {"num_outputs": 3}, {"fix_gamma": False})


def test_same_names_and_counts():
    assert set(T) == set(J)
    assert len(J) == 298
    assert len({op.name for op in T.values()}) == \
        len({op.name for op in J.values()}) == 201


def _resolved(op, attrs):
    out = {}
    for what, get in (("inputs", op.get_input_names),
                      ("aux", op.get_aux_names),
                      ("num_outputs", op.get_num_outputs),
                      ("outputs", op.get_output_names)):
        try:
            out[what] = get(attrs)
        except Exception as e:  # noqa: BLE001 — both must fail alike
            out[what] = type(e).__name__
    return out


@pytest.mark.parametrize("name", sorted(J))
def test_op_definition_matches(name):
    jop, top = J[name], T[name]
    assert top.name == jop.name
    assert set(top.aliases) == set(jop.aliases)
    assert top.variable_inputs == jop.variable_inputs
    assert top.needs_is_train == jop.needs_is_train
    assert top.needs_rng == jop.needs_rng
    assert top.hidden == jop.hidden
    for attrs in ATTR_SETS:
        assert _resolved(top, attrs) == _resolved(jop, attrs), attrs
    assert _public(top.accepted_attrs()) == _public(jop.accepted_attrs())


def _public(attrs):
    """Accepted attributes without the lowering functions' private
    defaults (a closure's ``_jfn`` / ``_tfn``)."""
    return attrs if attrs is None else {a for a in attrs
                                        if not a.startswith("_")}
