"""Config, losses, metrics, the train step and the train loop."""
