"""Training substrate of the port: optimizers, the train-step factory,
the data pipeline, gradient compression, and the serving step
factories."""
from . import data, grad_compress, optimizer, serve_step, train_step
