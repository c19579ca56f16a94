"""The LM substrate's models: parameter declarations (``common``), the
configuration (``config``), the mixers (``attention``, ``ssm``,
``rglru``), the MLPs (``mlp``), the stack (``transformer``) and the
carry-across of the reference's parameters (``convert``)."""
