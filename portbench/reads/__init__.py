"""Read kinds: each module makes a read's DQL text from the seed, and
holds the plain reference that judges its answer. Found by the `read`
key of a traffic file. Nothing here imports the port."""
