"""The port's sharded trainer on the mesh (4, 1, 1): four replicas, each rank
one row of the global batch, against the JAX package's
``make_sharded_trainer`` on 4 of the 8 CPU devices
(``tests/test_torch_parallel.py`` sets both up and holds the (1, 2, 2)
mesh; one JAX compile a file, so that each file stays short)."""

import pytest

from test_torch_parallel import MESHES, check_mesh_parity, mesh_parity

pytestmark = pytest.mark.fast

NAME = "4x1x1"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mesh_parity(tmp_path_factory.mktemp("parallel_data"), NAME)


def test_mesh_4x1x1_matches_jax(runs):
    """Loss, token_accuracy and grad_norm at every step on every rank, the
    parameters after the steps, and each rank's bytes against a JAX
    device's."""
    check_mesh_parity(*runs, MESHES[NAME])
