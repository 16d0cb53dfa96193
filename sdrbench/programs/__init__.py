"""The programs under test, one module a configuration's ``program``:
``stages(config)``, the port's stages and the input dtype."""
