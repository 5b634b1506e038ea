"""The serving models of the port: the weight tree, the dense decode model
that prefills prompts, and the paged decode model plus its batcher."""
