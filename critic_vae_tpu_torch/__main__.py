import sys

from critic_vae_tpu_torch.cli import main

sys.exit(main())
