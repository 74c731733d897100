from kubernetes_tpu_torch.cli.kubectl import main

raise SystemExit(main())
