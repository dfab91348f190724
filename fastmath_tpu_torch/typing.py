"""Generic one-or-several aliases."""
from typing import Sequence, Tuple, TypeVar, Union

T = TypeVar("T")

OneOrTwo = Union[T, Tuple[T, T]]
OneOrSeveral = Union[T, Sequence[T]]

__all__ = ["OneOrTwo", "OneOrSeveral"]
