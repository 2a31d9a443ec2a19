"""Model families: what the benchmark builds for a configuration whose
``family`` names the file. A family makes the benchmark's inputs from the
seed, hands them to the program's public entry points (bank, event,
models, configs) and lists its networks' layers for the operation counts;
its plain side (networks, parameter sets, the reference's own data) is
``benchmark/reference/<family>.py``. A configuration of a new family adds
both files; one of an existing family adds only its JSON."""
