"""The registry and the meters of the training path."""
