"""The UNDEFINED sentinel.

Semantics follow the reference's gridmapping/undefined.py:25-44: a
singleton distinct from ``None`` so APIs can distinguish "caller passed
None on purpose" from "caller passed nothing".
"""


class _Undefined:
    __slots__ = ()

    def __repr__(self):
        return "UNDEFINED"

    __str__ = __repr__

    def __eq__(self, other):
        return isinstance(other, _Undefined)

    def __hash__(self):
        return hash("UNDEFINED") + 1


UNDEFINED = _Undefined()
