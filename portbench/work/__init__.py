"""Operation and byte counts of the port's work, one count a file, from
shapes alone (see ``portbench/README.md``)."""
