from .nerf_synthetic import SubjectLoader, Rays
from .fixture import make_fixture_scene, write_fixture_dataset

__all__ = [
    "SubjectLoader",
    "Rays",
    "make_fixture_scene",
    "write_fixture_dataset",
]
