"""The port's programs: the batch renderer and the interactive viewer
(ports of `apps.render_batch` and `apps.viewer`)."""
