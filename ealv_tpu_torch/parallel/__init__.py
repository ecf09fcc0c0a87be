from .mesh import Mesh, make_mesh
from .train import dp_train_call, sharded_pdf
