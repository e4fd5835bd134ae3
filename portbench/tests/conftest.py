# ``added_cells/`` holds files that a test copies into a copy of the
# benchmark; its tests run there, against the cells it adds, not here.
collect_ignore = ["added_cells"]
