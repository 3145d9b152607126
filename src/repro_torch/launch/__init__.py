"""Entry points of the port: the train state/step and the trainer CLI."""
