"""The FL runtime: config, client/server stages, batched engine, rounds."""
