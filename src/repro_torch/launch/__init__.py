"""Launchers of the port: the LM demo (``serve``), the domain-map dry run
(``dryrun``) and the deployment analytics it reports (``analytic``)."""
