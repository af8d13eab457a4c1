"""Eager argument checks.

Error-message wording tracks the reference's assertion helpers
(reference gridmapping/assertions.py:28-93) because the parity tests
pin the messages; the implementation here is a thin table of
predicate -> message builders.
"""

from __future__ import annotations

from collections.abc import Container
from typing import Any


def _fail(exc: type[Exception], name: str | None, tail: str):
    raise exc(f"{name or 'value'} {tail}")


def assert_given(value: Any, name: str = None, exception_type=ValueError):
    """*value* must be truthy."""
    if not value:
        _fail(exception_type, name, "must be given")


def assert_instance(value: Any, dtype, name: str | None = None, exception_type=TypeError):
    """*value* must be an instance of *dtype* (type or tuple of types)."""
    if not isinstance(value, dtype):
        _fail(
            exception_type,
            name,
            f"must be an instance of {dtype}, was {type(value)}",
        )


def assert_in(value: Any, container: Container, name: str = None, exception_type=ValueError):
    """*value* must be a member of *container*."""
    if value not in container:
        _fail(exception_type, name, f"must be one of {container}")


def assert_true(value: Any, message: str, exception_type=ValueError):
    """*value* must be truthy, else raise with the verbatim *message*."""
    if not value:
        raise exception_type(message)
