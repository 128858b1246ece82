"""Deployments: each module makes a configuration's data from the seed
and loads it into the port. Found by the `system` key of a
configuration's file."""
