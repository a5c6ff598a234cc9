from se3_icp.cli import main

main()
